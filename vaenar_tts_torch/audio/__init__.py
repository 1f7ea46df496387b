"""Audio: the numpy DSP, the streaming vocoder and the artifact writers."""
