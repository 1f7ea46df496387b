"""The VAENAR model as torch modules."""
