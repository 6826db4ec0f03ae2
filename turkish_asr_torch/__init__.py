"""turkish_asr_torch — the Turkish Conformer-CTC ASR system in PyTorch and CUDA.

A port of ``turkish_asr_tpu`` (JAX, the reference) to an NVIDIA H100:
PyTorch for the tensor code, hand-written CUDA C++ for the Hopper kernels
(``csrc/``, built with nvcc at first use). The package imports torch and
never jax. Subpackages mirror the JAX package's layout. Entry points:
serving (``serve/server.py``, ``inference.py``), training (``main.py``,
over several GPUs under torchrun with ``parallel/``), export
(``export_model.py``), the bench (``bench.py``), the tokenizer trainer
(``spm_train.py``) and the multi-rank dryrun (``multichip.py``).
"""
