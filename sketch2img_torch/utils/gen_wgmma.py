"""Write ``csrc/wgmma_ops.cuh``: the ``wgmma.mma_async`` wrappers the Hopper
flash kernels use, one per accumulator width N.

An inline-PTX ``wgmma`` lists every accumulator register as an operand (N/2
of them for an m64nNk16 fp32 product), which the C preprocessor cannot
spell out; this script writes them.

    python -m sketch2img_torch.utils.gen_wgmma      # rewrite the header

``tests/test_torch_flash_attention.py`` checks that the committed header is
what ``render()`` gives.
"""

from __future__ import annotations

import os

from sketch2img_torch.utils.cuda_build import CSRC_DIR

HEADER = "wgmma_ops.cuh"
# S = Q K^T (forward, N = key tile: 192 in its 192-query tile) and S^T =
# K Q^T, dP^T = V dO^T (dK/dV pass, N = query tile): both operands in shared
# memory, K-major
SS_WIDTHS = (32, 64, 128, 192)
# O += P V and dV += P^T dO, dK += dS^T Q: A from registers, B MN-major
# (N = the head-dim bucket, or half of it where the dK/dV pass splits it)
RS_WIDTHS = (32, 48, 64, 80, 96, 128, 160, 192, 256)


def _regs(first: int, count: int) -> str:
    return ", ".join(f"%{first + i}" for i in range(count))


def _outs(count: int) -> str:
    lines, row = [], []
    for i in range(count):
        row.append(f'"+f"(d[{i}])')
        if len(row) == 8:
            lines.append(", ".join(row))
            row = []
    if row:
        lines.append(", ".join(row))
    return ",\n        ".join(lines)


def _ss(n: int) -> str:
    r = n // 2
    return f"""  // m64n{n}k16, A and B in shared memory (K-major both)
  static __device__ __forceinline__ void ss(float (&d)[{r}], uint64_t da, uint64_t db,
                                            int accumulate) {{
    asm volatile(
        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 2}, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
        "{{{_regs(0, r)}}}, %{r}, %{r + 1}, p, 1, 1, 0, 0;\\n}}\\n"
        : {_outs(r)}
        : "l"(da), "l"(db), "r"(accumulate));
  }}
"""


def _rs(n: int) -> str:
    r = n // 2
    return f"""  // m64n{n}k16, A from registers (four bf16x2 a thread), B in shared memory MN-major
  static __device__ __forceinline__ void rs(float (&d)[{r}], const uint32_t (&a)[4], uint64_t db,
                                            int accumulate) {{
    asm volatile(
        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 5}, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
        "{{{_regs(0, r)}}}, {{{_regs(r, 4)}}}, %{r + 4}, p, 1, 1, 1;\\n}}\\n"
        : {_outs(r)}
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  }}
"""


def render() -> str:
    parts = [
        "// Generated by sketch2img_torch/utils/gen_wgmma.py; do not edit by hand.\n"
        "//\n"
        "// hp::Wgmma<N>::ss / ::rs issue one wgmma.mma_async.m64nNk16 (bf16 in, fp32\n"
        "// accumulators d[N/2] a thread) for the warpgroup. `accumulate` = 0 overwrites d.\n"
        "// The caller brackets them with wgmma.fence / commit_group / wait_group.\n\n"
        "#pragma once\n\n#include <stdint.h>\n\nnamespace hp {\n\n"
        "template <int N>\nstruct Wgmma;\n"
    ]
    for n in sorted(set(SS_WIDTHS) | set(RS_WIDTHS)):
        body = (_ss(n) if n in SS_WIDTHS else "") + (_rs(n) if n in RS_WIDTHS else "")
        parts.append(f"\ntemplate <>\nstruct Wgmma<{n}> {{\n{body}}};\n")
    parts.append("\n}  // namespace hp\n")
    return "".join(parts)


def main() -> None:
    path = os.path.join(CSRC_DIR, HEADER)
    with open(path, "w") as f:
        f.write(render())
    print(path)


if __name__ == "__main__":
    main()
