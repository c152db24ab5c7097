"""ladder_tpu_torch — LaDDer on PyTorch and CUDA (NVIDIA Hopper).

The port of ``ladder_tpu`` (JAX on a TPU), which stays in the repository as
the reference. The module layout and names follow ``ladder_tpu``'s; the
modules are PyTorch (``nn.Module``s, NCHW inside, explicit devices and
generators), and each Pallas TPU kernel becomes a hand-written CUDA kernel
under ``csrc/``, built with nvcc at first use. This package imports neither
JAX nor anything of ``ladder_tpu``.

Ported so far: serving the CelebA-128 model family (``serving.InferenceEngine``,
``python -m ladder_tpu_torch.serve``) and its joint train step
(``training.step.make_train_step``, with the losses, the per-group TF1-style
Adam and the schedules). ROADMAP.md lists what comes next.
"""

__version__ = "0.1.0"
