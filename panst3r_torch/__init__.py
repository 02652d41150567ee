"""PyTorch / CUDA port of panst3r_tpu for one NVIDIA H100 (sm_90a).

Module names mirror ``panst3r_tpu`` (``panst3r_torch/models/encoder.py`` is
the counterpart of ``panst3r_tpu/models/encoder.py``).  The attention hot
paths run through hand-written CUDA kernels built from ``csrc/`` at first
use (see ``ops/cuda_build.py``); every entry point runs on the card unless
the caller passes ``device="cpu"``.
"""
