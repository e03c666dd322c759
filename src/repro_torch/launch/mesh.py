"""The card's constants for the roofline analysis, twin of ``repro.launch.mesh``.

The port runs on one NVIDIA H100 80GB HBM3 (SXM, 700 W). Its published dense
peaks, and the memory that ``torch.cuda.get_device_properties(0).total_memory``
reports on it. The JAX package's meshes (``make_production_mesh``,
``make_test_mesh``) are multi-device layouts: they come with sharding, and on one
card there is none.
"""
from __future__ import annotations

PEAK_FLOPS_BF16 = 989e12       # dense bf16 tensor-core flop/s
HBM_BW = 3.35e12               # HBM3 bytes/s
# total_memory of an NVIDIA H100 80GB HBM3 (torch.cuda.get_device_properties on
# the card; chip_smoke.py prints it and checks this value)
HBM_BYTES = 85_017_493_504
CHIPS = 1
