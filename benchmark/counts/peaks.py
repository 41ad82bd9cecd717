"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W limit): the yardstick of every roofline and mfu share.

Why it is here: a share is only comparable between PRs if its peak never
moves. No peak is derived from a measurement or from a unit's rate (there
is no exponential term: a kernel may compute exp2 elsewhere than the SFU).
"""

#: tensor-core FLOP/s by the dtype a configuration states for a module
FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
#: HBM3 bytes/s
HBM_BYTES = 3.35e12
