"""Interop: the JAX package's flax trees onto the port's modules and back
(``weights.py``), and the reference implementation's ``tf.train.Checkpoint``
files, read and written in numpy (``tensorbundle.py``, ``weight_map.py``,
``importer.py``)."""
