"""The four resource stressors: wrappers of the CUDA kernels in
``csrc/stressors.cu`` and their plain PyTorch versions.

Replace the TPU kernels of ``src/repro/kernels/stressors.py`` (the paper's
§4.1 benchmark suite): ``stress_mxu`` (tensor cores, or the FP32 pipes for
f32), ``stress_vpu`` (the ILP sweep on the FP32 pipes), ``stress_hbm`` (a
streaming copy) and ``stress_vmem`` (shared-memory bank conflicts). Each
computes the function of the reference's oracle (``repro/kernels/ref.py``)
so that a run can check its output, and loads its resource on as many SMs
as it has blocks: the grid is the reference's grid (one block per tile, per
256-row block, per copy share, per 512-row block and 32-column strip).

A tensor on the CPU takes the plain version; a CUDA tensor launches the
kernel or raises. ``stress_vpu`` and ``stress_vmem`` take f32 or bf16 x,
loop in f32 and return ``x.dtype``, as the Pallas kernels cast; their
``admit_*`` functions are what the wrappers take, checked before any
launch.
"""
from __future__ import annotations

from collections import Counter

import torch

from repro_torch.kernels import _build

MXU_TILE = 128            # the one tile size the mxu kernel takes
VMEM_STRIP = 32           # columns of a stress_vmem block
MAX_ILP = 8


# --------------------------------------------------------------------- #
#  shape checks: the reference's asserts, as ValueError                  #
# --------------------------------------------------------------------- #
def _rows_blocked(what: str, x: torch.Tensor, block_rows: int) -> tuple:
    """(R, C, br) of a 2-D x whose rows split into blocks of
    ``br = min(block_rows, R)``, as ``stressors.py:79,101,131`` assert."""
    if x.dim() != 2 or x.shape[0] == 0:
        raise ValueError(f"{what}: x must be a non-empty (R, C) matrix, got "
                         f"{tuple(x.shape)}")
    R, C = x.shape
    br = min(block_rows, R)
    if br <= 0 or R % br:
        raise ValueError(f"{what}: {R} rows do not split into blocks of {br}")
    return R, C, br


def _mxu_shapes(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.dim() != 3 or a.shape[1] != a.shape[2] or b.shape != a.shape[1:]:
        raise ValueError(f"stress_mxu: a must be (n, T, T) and b (T, T), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    return a.shape[1]


def _device(what: str, *ts: torch.Tensor) -> str:
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError(f"{what}: all tensors must be on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    return dev.type


# --------------------------------------------------------------------- #
#  stress_mxu                                                            #
# --------------------------------------------------------------------- #
def stress_mxu_plain(a: torch.Tensor, b: torch.Tensor, iters: int = 64) -> torch.Tensor:
    """Per tile, ``iters`` times ``c <- c @ b`` (f32 products), then
    ``c <- c / max(max|c|, 1)``; returns c in ``a.dtype``. c is rounded to
    ``a.dtype`` before each product: a no-op for f32, and for bf16 what the
    tensor cores take as their A operand."""
    _mxu_shapes(a, b)
    bf = b.float()
    c = a.float()
    for _ in range(iters):
        c = torch.matmul(c.to(a.dtype).float(), bf)
        m = c.abs().amax(dim=(1, 2), keepdim=True)
        c = c / torch.clamp(m, min=1.0)
    return c.to(a.dtype)


def stress_mxu(a: torch.Tensor, b: torch.Tensor, iters: int = 64) -> torch.Tensor:
    """a: (n_tiles, T, T); b: (T, T), f32 or bf16. FLOPs = n_tiles * iters
    * 2 T^3. On the card T must be 128: bf16 runs on the tensor cores, f32
    exactly in FFMA."""
    T = _mxu_shapes(a, b)
    if _device("stress_mxu", a, b) == "cpu":
        return stress_mxu_plain(a, b, iters)
    if a.dtype not in _build.DTYPE_CODES or b.dtype != a.dtype:
        raise TypeError(f"stress_mxu: unsupported dtypes {a.dtype}, {b.dtype}")
    if T != MXU_TILE:
        raise ValueError(f"stress_mxu: the kernel takes T = {MXU_TILE}, got {T}")
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty_like(a)
    rc = _build.load().rt_stress_mxu(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                     a.shape[0], T, int(iters),
                                     _build.DTYPE_CODES[a.dtype], _build.stream_ptr())
    _build.check_launch(rc, f"stress_mxu{tuple(a.shape)}")
    stress_mxu.launches += 1
    return out


stress_mxu.launches = 0     # launches of the CUDA kernel by this wrapper


# --------------------------------------------------------------------- #
#  stress_vpu                                                            #
# --------------------------------------------------------------------- #
def stress_vpu_plain(x: torch.Tensor, iters: int = 256, ilp: int = 4) -> torch.Tensor:
    """``ilp`` chains ``acc <- acc * 1.000001 + 0.5`` from ``x + i``, output
    ``sum(acc) / (4 ilp)`` (the chains stacked on a leading axis)."""
    _rows_blocked("stress_vpu", x, 256)
    xf = x.float()
    acc = torch.stack([xf + i for i in range(ilp)])
    for _ in range(iters):
        acc.mul_(1.000001).add_(0.5)
    out = acc[0]
    for i in range(1, ilp):
        out = out + acc[i]
    return (out / (ilp * 4.0)).to(x.dtype)


def admit_vpu(x: torch.Tensor, ilp: int = 4) -> tuple:
    """What the kernel of ``stress_vpu`` takes, as the wrapper checks it
    before any launch: raises ValueError or TypeError naming the wrapper.
    Returns (R, C, br)."""
    R, C, br = _rows_blocked("stress_vpu", x, 256)
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"stress_vpu: the kernel takes float32 or bfloat16, got {x.dtype}")
    if not 1 <= ilp <= MAX_ILP:
        raise ValueError(f"stress_vpu: ilp must be 1..{MAX_ILP}, got {ilp}")
    return R, C, br


def stress_vpu(x: torch.Tensor, iters: int = 256, ilp: int = 4) -> torch.Tensor:
    """x: (R, C) f32 or bf16, R a multiple of min(256, R). VPU-flops = R *
    C * iters * ilp * 2."""
    if _device("stress_vpu", x) == "cpu":
        return stress_vpu_plain(x, iters, ilp)
    R, C, br = admit_vpu(x, ilp)
    x = x.contiguous()
    out = torch.empty_like(x)
    rc = _build.load().rt_stress_vpu(x.data_ptr(), out.data_ptr(), x.numel(), br * C,
                                     R // br, int(iters), int(ilp),
                                     _build.DTYPE_CODES[x.dtype], _build.stream_ptr())
    _build.check_launch(rc, f"stress_vpu{tuple(x.shape)}")
    stress_vpu.launches += 1
    return out


stress_vpu.launches = 0


# --------------------------------------------------------------------- #
#  stress_hbm                                                            #
# --------------------------------------------------------------------- #
def stress_hbm_plain(x: torch.Tensor, block_rows: int = 1024, passes: int = 1) -> torch.Tensor:
    """A copy of x."""
    _rows_blocked("stress_hbm", x, block_rows)
    return x.clone()


def stress_hbm(x: torch.Tensor, block_rows: int = 1024, passes: int = 1) -> torch.Tensor:
    """Streaming copy, ``out == x`` bit for bit, any type; bytes = 2 * passes
    * x.nbytes. One block per ``block_rows`` rows, as the reference's grid;
    ``passes`` (not in the reference) repeats the copy inside the kernel, so
    that a small working set still makes a long dispatch."""
    R, C, br = _rows_blocked("stress_hbm", x, block_rows)
    if passes < 1:
        raise ValueError(f"stress_hbm: passes must be >= 1, got {passes}")
    if _device("stress_hbm", x) == "cpu":
        return stress_hbm_plain(x, block_rows, passes)
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("stress_hbm: x must be 16-byte aligned")
    out = torch.empty_like(x)
    rc = _build.load().rt_stress_hbm(x.data_ptr(), out.data_ptr(),
                                     x.numel() * x.element_size(), R // br,
                                     int(passes), _build.stream_ptr())
    _build.check_launch(rc, f"stress_hbm{tuple(x.shape)}")
    stress_hbm.launches += 1
    return out


stress_hbm.launches = 0


# --------------------------------------------------------------------- #
#  stress_vmem                                                           #
# --------------------------------------------------------------------- #
def stress_vmem_plain(x: torch.Tensor, iters: int = 64, stride: int = 8) -> torch.Tensor:
    """Per block of min(512, R) rows, ``iters`` times ``y <- y + roll(y,
    stride, rows)``, output ``y / 2^iters``: computed as ``y <- (y + roll) /
    2`` per step, which is the same bit for bit wherever the reference's
    form stays finite (a power of two commutes with rounding) and stays
    finite beyond it."""
    R, C, br = _rows_blocked("stress_vmem", x, 512)
    y = x.float().reshape(R // br, br, C)
    for _ in range(iters):
        y = (y + torch.roll(y, stride, dims=1)) * 0.5
    return y.reshape(R, C).to(x.dtype)


def admit_vmem(x: torch.Tensor) -> tuple:
    """What the kernel of ``stress_vmem`` takes, as the wrapper checks it
    before any launch: raises ValueError or TypeError naming the wrapper.
    Returns (R, C, br)."""
    R, C, br = _rows_blocked("stress_vmem", x, 512)
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"stress_vmem: the kernel takes float32 or bfloat16, got {x.dtype}")
    if C % VMEM_STRIP:
        raise ValueError(f"stress_vmem: the kernel takes C a multiple of "
                         f"{VMEM_STRIP}, got {C}")
    return R, C, br


def stress_vmem(x: torch.Tensor, iters: int = 64, stride: int = 8) -> torch.Tensor:
    """x: (R, C) f32 or bf16, R a multiple of min(512, R), and on the card C
    a multiple of 32; y is kept in f32 in shared memory whatever x's type.
    Shared-memory traffic = iters * 3 * 4 bytes per element (two reads, one
    write)."""
    if _device("stress_vmem", x) == "cpu":
        return stress_vmem_plain(x, iters, stride)
    R, C, br = admit_vmem(x)
    x = x.contiguous()
    out = torch.empty_like(x)
    rc = _build.load().rt_stress_vmem(x.data_ptr(), out.data_ptr(), R, C, br,
                                      int(iters), int(stride),
                                      _build.DTYPE_CODES[x.dtype], _build.stream_ptr())
    _build.check_launch(rc, f"stress_vmem{tuple(x.shape)}")
    stress_vmem.launches += 1
    return out


stress_vmem.launches = 0


def vmem_conflict_degree(stride: int, br: int) -> float:
    """Wavefronts of one warp's shared-memory access in the kernel of
    ``stress_vmem``, on average over the block's warps: its bound counts
    them. Lane j of a block of ``br`` rows takes row ``(j s + floor(j s /
    br)) mod br`` of its column when ``s = stride mod br`` divides br (else
    row j), a column's rows lie in consecutive words, and a warp's 32 rows
    take as many wavefronts as the most of them that share a bank (row mod
    32): 1 at stride 1, 8 at 8 and 16 at 32 when br is 512."""
    shift = stride % br
    permute = shift > 0 and br % shift == 0
    rows = [(j * shift + j * shift // br) % br if permute else j for j in range(br)]
    worst = [max(Counter(r % 32 for r in rows[w:w + 32]).values())
             for w in range(0, br, 32)]
    return sum(worst) / len(worst)
