"""Weight export reader."""
