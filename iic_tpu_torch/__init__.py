"""PyTorch port of iic_tpu for one NVIDIA GPU (H100, sm_90a).

Module paths mirror the JAX package ``iic_tpu``, which stays the reference
the port is tested against. The port imports ``torch`` and never JAX.
Ported so far: the two-head segmentation training slice, with the
displacement-joint kernels hand-written in CUDA (``csrc/seg_joint.cu``).
"""
