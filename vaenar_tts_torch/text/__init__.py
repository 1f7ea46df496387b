"""Text normalisation and tokenisation."""
