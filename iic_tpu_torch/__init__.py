"""PyTorch port of iic_tpu for one NVIDIA GPU (H100, sm_90a).

Module paths mirror the JAX package ``iic_tpu``, which stays the reference
the port is tested against. The port imports ``torch`` and never JAX.
Ported so far: the segmentation, clustering and semisup trainers and the
trainable baselines, with the displacement-joint kernels hand-written in
CUDA (``csrc/seg_joint.cu``) and the fused IID-loss kernel
(``csrc/iid_loss.cu``); the experiment tool's kernels; and a trained
run's serving (``infer.py``, ``cli/export_model.py``), the reference
checkpoints' import (``compat/torch_import.py``, ``cli/import_torch.py``)
and the analysis tools (``cli/analysis``, ``utils/render.py``).
"""
