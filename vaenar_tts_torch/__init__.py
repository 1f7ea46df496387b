"""VAENAR-TTS in PyTorch for NVIDIA Hopper: the port of ``vaenar_tts_tpu``.

The modules mirror the JAX package's names. Weights come from the JAX
package's ``export.npz`` through ``interop.weights``. Masked attention runs
through a hand-written CUDA kernel (``ops.flash_attention``) on CUDA tensors
and through its plain PyTorch version on CPU tensors.
"""
