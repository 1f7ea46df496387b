"""VAENAR-TTS in PyTorch for NVIDIA Hopper: the port of ``vaenar_tts_tpu``.

The modules mirror the JAX package's names. Weights come from, and go
back to, the JAX package's ``export.npz`` through ``interop.weights``.
Masked attention and its gradient run through hand-written CUDA kernels
(``ops.flash_attention``) on CUDA tensors and through their plain PyTorch
versions on CPU tensors. ``cli.inference`` synthesizes (test set or free
text, mels and wavs); ``cli.train`` trains; ``cli.train_vocoder`` trains
the neural ISTFT-head vocoder (``models.vocoder``). ``ops.stft`` and
``ops.griffin_lim`` are the mel frontend and Griffin-Lim in torch ops;
``audio`` holds the numpy DSP, the streaming vocoder and the writers.
"""
