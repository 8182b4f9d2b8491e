"""Adam's update of the trained leaves as one multi-tensor CUDA kernel
(csrc/adam.cu; no TPU kernel: XLA fuses optax's update in the JAX package).

train/optim.py::Optimizer.step hands the CUDA leaves here while the "adam"
kernel is enabled (ops/select.py), and runs its per-leaf loop of PyTorch ops
for CPU leaves: the loop is the plain version, and the kernel computes its
arithmetic bit for bit (csrc/adam.cu's header).

- `adam_table` turns the leaves into table entries: p and g as n / inner
  rows of inner elements, rows p_stride / g_stride apart (a whole leaf is
  one row, a ZeRO-1 piece narrowed on any dim its rows), m and v dense. It
  reads only shapes, strides, dtypes and pointers, so it runs on CPU
  tensors too (the tests walk its entries). It raises on a leaf the kernel
  does not take: a param or gradient not f32, a moment not f32 or bf16, p
  or g not such rows, m or v not dense.
- `pack` lays the entries out as csrc's `Entry` rows (`ENTRY`), each leaf
  cut into chunks of CHUNK elements.
- `adam_update` raises unless every tensor is on one card, packs the
  table, copies it to the card from pinned memory on the current stream (the pinned block is not handed out again before
  the copy is done: PyTorch's host allocator records the copy), and
  launches once for each pair of moment dtypes: one launch a step with
  the flags' dtypes, where the loop made ~13 a leaf.
"""

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from wav2vec2forbrain_tpu_torch.ops import kernels

CHUNK = 8192  # elements a block updates at a time (a multiple of 4)
BLOCKS_PER_SM = 8  # csrc's 256 threads a block: 2048 threads an SM
# csrc/adam.cu's Entry, 80 bytes
ENTRY = np.dtype([("p", "<u8"), ("g", "<u8"), ("m", "<u8"), ("v", "<u8"), ("p_stride", "<i8"), ("g_stride", "<i8"),
                  ("n", "<i8"), ("inner", "<i8"), ("chunk0", "<i4"), ("vec", "<i4"), ("neg_lr", "<f4"),
                  ("pad", "<i4")])


class AdamLeaf(NamedTuple):
    """A trained leaf (or this rank's ZeRO-1 piece of it): the param, its
    gradient (None: zero), the moments, the lr of its group."""

    p: torch.Tensor
    g: Optional[torch.Tensor]
    m: torch.Tensor
    v: torch.Tensor
    lr: float


class AdamScalars(NamedTuple):
    """One step's scalars, as Python floats (each taken as f32, as PyTorch
    takes a Python scalar operand)."""

    b1: float
    b2: float
    eps: float
    weight_decay: float
    inv_bc1: float  # the f32 reciprocals of the bias corrections 1 - b ** count
    inv_bc2: float
    stock: bool  # optax's scale_by_adam (nu_dtype None), else f32 throughout


class Entry(NamedTuple):
    """One table entry: the leaf and its ENTRY row, which holds p and g as
    n / inner rows of inner elements, p_stride and g_stride elements apart
    (m and v dense), and chunk0 0 (`pack` numbers the chunks)."""

    leaf: AdamLeaf
    row: tuple


def rows(t: torch.Tensor, n: int) -> Optional[Tuple[int, int, int]]:
    """(outer, inner, stride) with t's n elements, in order, at offset
    i * stride + j of its data_ptr for row i < outer, j < inner; None
    where no such rows hold them."""
    if t.is_contiguous():
        return 1, n, n
    dims = [(size, st) for size, st in zip(t.shape, t.stride()) if size != 1]
    inner, k = 1, len(dims)
    while k and dims[k - 1][1] == inner:  # the trailing dims that are one dense run
        inner *= dims[k - 1][0]
        k -= 1
    if k == 0:
        return 1, n, n
    outer, stride = dims[k - 1]
    for size, st in reversed(dims[:k - 1]):  # the leading ones, one run of rows
        if st != stride * outer:
            return None
        outer *= size
    return outer, inner, stride


_QUAD_BYTES = {torch.float32: 16, torch.bfloat16: 8}  # 4 elements of a moment


def adam_table(leaves: List[AdamLeaf]) -> List[Entry]:
    """The table's entries of leaves (the module docstring)."""
    f32 = torch.float32
    entries = []
    for leaf in leaves:
        p, g, m, v, lr = leaf
        n = p.numel()
        if p.dtype is not f32 or (g is not None and g.dtype is not f32):
            raise ValueError(f"adam: params and gradients must be float32, got {p.dtype} and "
                             f"{None if g is None else g.dtype}")
        m_quad, v_quad = _QUAD_BYTES.get(m.dtype), _QUAD_BYTES.get(v.dtype)
        if m_quad is None or v_quad is None:
            raise ValueError(f"adam: moments must be float32 or bfloat16, got {m.dtype} and {v.dtype}")
        if not (m.is_contiguous() and v.is_contiguous() and m.numel() == n == v.numel()):
            raise ValueError(f"adam: moments must be dense tensors of the param's {n} elements")
        p_rows = rows(p, n)
        g_rows = p_rows if g is None else rows(g, n)
        if p_rows is None or g_rows is None or (g is not None and (g.shape != p.shape or g_rows[:2] != p_rows[:2])):
            raise ValueError(f"adam: a param {tuple(p.shape)} / {p.stride()} and its gradient must be rows of "
                             f"one length (got {p_rows} and {g_rows})")
        if not n:
            continue
        _, inner, p_stride = p_rows
        g_stride = g_rows[2]
        pp, gp, mp, vp = p.data_ptr(), 0 if g is None else g.data_ptr(), m.data_ptr(), v.data_ptr()
        vec = (pp % 16 == 0 and gp % 16 == 0 and mp % m_quad == 0 and vp % v_quad == 0 and inner % 4 == 0
               and p_stride % 4 == 0 and g_stride % 4 == 0)
        entries.append(Entry(leaf, (pp, gp, mp, vp, p_stride, g_stride, n, inner, 0, int(vec), -lr, 0)))
    return entries


def pack(entries: List[Entry]) -> Tuple[np.ndarray, int]:
    """(the ENTRY rows of entries, the chunks they hold)."""
    table = np.array([e.row for e in entries], ENTRY)
    chunks = -(-table["n"] // CHUNK)
    table["chunk0"] = np.cumsum(chunks) - chunks
    return table, int(chunks.sum())


def adam_update(leaves: List[AdamLeaf], s: AdamScalars) -> None:
    """Update every leaf in place (p, m, v) on the card: the table copied
    once, one launch for each pair of moment dtypes."""
    entries = adam_table(leaves)
    if not entries:
        return
    dev = entries[0].leaf.p.device
    if dev.type != "cuda" or any(t is not None and t.get_device() != dev.index for e in entries for t in e.leaf[:4]):
        raise ValueError(f"adam: every param, gradient and moment must be a CUDA tensor on {dev}")
    groups = {}
    for e in entries:
        groups.setdefault((e.leaf.m.dtype, e.leaf.v.dtype), []).append(e)
    packed = [(dtypes, *pack(group)) for dtypes, group in groups.items()]
    host = torch.from_numpy(np.concatenate([table for _, table, _ in packed]).view(np.uint8)).pin_memory()
    table = host.to(dev, non_blocking=True)
    grid_max = BLOCKS_PER_SM * torch.cuda.get_device_properties(dev).multi_processor_count
    lib = kernels.lib()
    at = 0
    with torch.cuda.device(dev):
        stream = kernels.stream_of(table)
        for (m_dtype, v_dtype), group, chunks in packed:
            b1 = float(torch.tensor(s.b1, dtype=m_dtype)) if s.stock else s.b1  # stock: the decay in m's dtype
            b2 = float(torch.tensor(s.b2, dtype=v_dtype)) if s.stock else s.b2
            code = lib.w2vb_adam(table.data_ptr() + at * ENTRY.itemsize, len(group), chunks, CHUNK,
                                 min(chunks, grid_max), int(m_dtype == torch.bfloat16),
                                 int(v_dtype == torch.bfloat16), int(s.stock), int(s.weight_decay != 0.0),
                                 s.weight_decay, 1 - s.b1, 1 - s.b2, b1, b2, s.inv_bc1, s.inv_bc2, s.eps, stream)
            kernels.check("adam", code)
            kernels.LAUNCHES["adam"] += 1
            at += len(group)
