"""Bidirectional GRU recurrence: the CUDA kernels' wrapper and the plain
versions (counterpart of wav2vec2forbrain_tpu/ops/pallas_gru.py::
gru_recurrence and ::gru_recurrence_dir, with their custom VJPs).

Per step, for each direction stacked on dim 1:
    gh = h_cd @ W_hh_cd + b_hh   (f32 accumulation; _cd = compute dtype)
    r = sig(gi_r + gh_r); z = sig(gi_z + gh_z); n = tanh(gi_n + r * gh_n)
    h' = (1 - z) * n + z * h     (h carried in f32)
Backward (the Pallas `_bwd_kernel`): reverse-time BPTT from the saved ys,
    dh = dh_carry + g[t];  dgr, dgz, dgn (-> dgi[t]) and dgh = [dgr, dgz, dgn * r]
    dh_carry = dh * z + dgh_cd @ W_hh_cd^T
    dW_hh = sum_t hprev_cd^T @ dgh_cd;  db_hh = sum_t sum_b dgh;  dh0 = dh_carry
The kernels are in csrc/gru.cu. `gru_recurrence` (the fused entry) takes a
hidden size H that is a multiple of 32, as the JAX package's fused kernel
needs lane-aligned gates. Its forward takes H <= 3584 by a shape rule
(`_fwd_route`): where a CTA's slice of W_hh fits its shared memory (bf16 H
<= 480, f32 H <= 320), one cluster-resident launch for all steps (a cluster
of 8 CTAs per direction and 16 batch rows, each holding its slice of W_hh
and exchanging h through distributed shared memory; counted as "gru"),
wider layers the per-direction step kernel (`_dir_fwd_kernel`, counted as
"gru_dir"), which computes the same numbers. Its backward takes H <= 480
(the widths models/gru.py routes to it).

`gru_recurrence_dir` is the counterpart of the JAX package's per-direction
variant (::gru_recurrence_dir, which it runs for H = 512 / 1024). Its
forward ("gru_dir") runs one launch per time step over (H / 32) x (B / 32)
x 2 blocks at any H and B (padded to Hp, Bp; it takes W_hh transposed,
`dir_fwd_weight`).

Both entries' backwards run the same kernels (`_bwd_launch`): gh for every
step in one launch, then one launch per reverse step over tiles of hidden
units x batch rows x direction (32 x 32, or 16 x 16 where that gives too
few blocks, as at H = 256, B = 32). They differ in dW_hh and db_hh. The
fused entry computes them as the JAX kernel does in its body: hprev and dgh
rounded to the compute dtype, one product over all T x B rows on the tensor
cores (bf16) in a kernel of its own, db from a per-row sum the steps keep.
The per-direction entry computes them, as JAX does (::_vjp_bwd_dir), from
an f32 product over all steps outside the kernels (`gru_dir_dw_db`), with
hprev and dgh not rounded. At f32 compute the two entries compute the same
function. LAUNCHES["gru_bwd"], ["gru_dir"] and ["gru_dir_bwd"] count entry
calls that launched the kernels, not their per-step launches.
"""

import functools

import torch

from wav2vec2forbrain_tpu_torch.ops import kernels

# the widest H that the fused forward takes and that models/gru.py routes
# per direction
DIR_MAX_HIDDEN = 3584
_DIR_BATCH_PAD, _DIR_HIDDEN_PAD = 32, 64  # the step kernels: Bp, Hp are multiples of these
_ROW_PAD = 64  # the fused dW product: its T x Bp rows padded to a multiple of this
_CLUSTER_CTAS, _CLUSTER_ROWS = 8, 16  # the cluster forward: CTAs per cluster, batch rows per cluster
_SMEM_MAX = 232448  # the most shared memory an H100 block may opt in to (227 KB)
# the fused backward's widest H: the widths models/gru.py routes to the fused
# entry (H < 512), which is also the JAX fused kernel's reach (both
# directions' weights in VMEM); gru_recurrence_dir takes wider layers
FUSED_BWD_MAX_HIDDEN = 480


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched product of compute-dtype operands with exact f32 products and
    f32 sums (the operands' values are representable in f32)."""
    return torch.bmm(a.float(), b.float())


def _gates(gi_t, gh):
    gi_r, gi_z, gi_n = gi_t.chunk(3, dim=-1)
    gh_r, gh_z, gh_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(gi_r + gh_r)
    z = torch.sigmoid(gi_z + gh_z)
    n = torch.tanh(gi_n + r * gh_n)
    return r, z, n, gh_n


def gru_recurrence_plain(gi, w_hh, b_hh, h0, compute_dtype=torch.float32):
    """gi (T, D, B, 3H) f32; w_hh (D, H, 3H); b_hh (D, 1, 3H) or (D, 3H);
    h0 (D, B, H) f32 -> ys (T, D, B, H) f32. Plain PyTorch version of the
    forward kernel (differentiable by autograd)."""
    w = w_hh.to(compute_dtype)
    bias = b_hh.reshape(b_hh.shape[0], 1, -1).float()
    h = h0.float()
    ys = []
    for t in range(gi.shape[0]):
        gh = _bmm_f32(h.to(compute_dtype), w) + bias
        r, z, n, _ = _gates(gi[t], gh)
        h = (1.0 - z) * n + z * h
        ys.append(h)
    return torch.stack(ys)


def gru_recurrence_bwd_plain(gi, w_hh, b_hh, h0, ys, g, compute_dtype=torch.float32, per_direction=False):
    """Plain version of the backward kernel: (dgi (T, D, B, 3H), dW_hh (D,
    H, 3H), db_hh (D, 1, 3H), dh0 (D, B, H)), all f32, for the upstream
    gradient g (T, D, B, H) of ys. per_direction takes dW_hh's product in
    f32 (gru_recurrence_dir), else in the compute dtype."""
    cd = compute_dtype
    dw_cd = torch.float32 if per_direction else cd
    w = w_hh.to(cd)
    w_t = w.transpose(1, 2)
    bias = b_hh.reshape(b_hh.shape[0], 1, -1).float()
    g = g.float()
    dh = torch.zeros_like(h0, dtype=torch.float32)
    dgi = torch.empty_like(gi, dtype=torch.float32)
    dw = torch.zeros(w_hh.shape, dtype=torch.float32, device=gi.device)
    db = torch.zeros(bias.shape, dtype=torch.float32, device=gi.device)
    for t in reversed(range(gi.shape[0])):
        hprev = (ys[t - 1] if t > 0 else h0).float()
        gh = _bmm_f32(hprev.to(cd), w) + bias
        r, z, n, gh_n = _gates(gi[t], gh)
        dh = dh + g[t]
        dn = dh * (1.0 - z)
        dz = dh * (hprev - n)
        dgn = dn * (1.0 - n * n)
        dr = dgn * gh_n
        dgz = dz * z * (1.0 - z)
        dgr = dr * r * (1.0 - r)
        dgi[t] = torch.cat([dgr, dgz, dgn], dim=-1)
        dgh = torch.cat([dgr, dgz, dgn * r], dim=-1)
        dh = dh * z + _bmm_f32(dgh.to(cd), w_t)
        dw = dw + _bmm_f32(hprev.to(dw_cd).transpose(1, 2), dgh.to(dw_cd))
        db = db + torch.sum(dgh, dim=1, keepdim=True)
    return dgi, dw, db, dh


def gru_dir_dw_db(h0, ys, dgh):
    """dW_hh (D, H, 3H) = einsum("tdbh,tdbk->dhk", hprev, dgh) and db_hh (D,
    1, 3H) = dgh summed over steps and batch rows, both f32, hprev = [h0,
    ys[:-1]] and dgh (T, D, B, 3H) not rounded: the JAX package's
    ::_vjp_bwd_dir, as one batched f32 matmul over the T * B rows. On the
    card it refuses to run with TF32 matmuls allowed."""
    if dgh.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "gru_recurrence_dir backward: its dW_hh is an f32 product, but "
            "torch.backends.cuda.matmul.allow_tf32 is True (TF32 keeps ~3 digits)"
        )
    hprev = torch.cat([h0[None], ys[:-1]])[: dgh.shape[0]].float()  # T = 0: no rows
    t, d, b, h = hprev.shape
    a = hprev.transpose(0, 1).reshape(d, t * b, h)
    g = dgh.float().transpose(0, 1).reshape(d, t * b, 3 * h)
    return torch.bmm(a.transpose(1, 2), g), g.sum(dim=1, keepdim=True)


def _check(gi, w_hh, b_hh, h0, compute_dtype, multiple_of_32=True):
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"gru_recurrence: compute dtype {compute_dtype} not supported")
    t, nd, b, h3 = gi.shape
    h = h3 // 3
    if gi.dtype != torch.float32 or h0.dtype != torch.float32:
        raise ValueError("gru_recurrence: gi and h0 must be float32")
    if w_hh.shape != (nd, h, h3) or h0.shape != (nd, b, h) or b_hh.numel() != nd * h3:
        raise ValueError(
            f"gru_recurrence: shapes gi {tuple(gi.shape)}, w_hh {tuple(w_hh.shape)}, "
            f"b_hh {tuple(b_hh.shape)}, h0 {tuple(h0.shape)} do not agree"
        )
    if h3 % 3 or (multiple_of_32 and h % 32):
        raise ValueError(f"gru_recurrence: hidden size {h} must be a multiple of 32")
    return t, nd, b, h


def _cluster_smem(h, compute_dtype):
    """Shared memory (bytes) of one CTA of the cluster forward at width h
    (csrc/gru.cu::cluster_smem): its W_hh slice and two h buffers of 16 rows
    (bf16 rows padded by 8 elements); at f32 also the partial products of
    three of its four K groups (12 values for each of 4 Up threads)."""
    up = _round_up(h // _CLUSTER_CTAS, 8)
    if compute_dtype == torch.bfloat16:
        return (3 * up + 2 * _CLUSTER_ROWS) * (h + 8) * 2
    return (3 * up + 2 * _CLUSTER_ROWS) * h * 4 + 3 * 12 * 4 * up * 4


def _fwd_route(h, compute_dtype):
    """The fused forward's kernel at width h (a multiple of 32): "cluster"
    where a CTA of an 8-CTA cluster holds its W_hh slice (bf16 h <= 480, f32
    h <= 320), else "steps" (the per-direction step kernel)."""
    return "cluster" if _cluster_smem(h, compute_dtype) <= _SMEM_MAX else "steps"


@functools.lru_cache(maxsize=None)
def _cluster_size(h, bf16, device_index):
    """The cluster size the card schedules for width h (8, else 4); raises
    where none fits. Asked once per shape and card."""
    with torch.cuda.device(device_index):
        cn = kernels.lib().w2vb_gru_fwd_cluster_size(h, int(bf16))
    if cn < 0:
        kernels.check("gru", -cn)
    if cn == 0:
        raise RuntimeError(f"gru_recurrence: no cluster of the forward kernel fits the card at H={h}")
    return cn


def _fwd_kernel(gi, w_hh, b_hh, h0, compute_dtype, per_direction=False):
    """The forward kernel of the fused entry, or with per_direction that of
    gru_recurrence_dir (the numbers are the same). The fused entry takes
    the cluster kernel or, at widths where its W_hh slices do not fit, the
    per-direction one (`_fwd_route`)."""
    if per_direction:
        return _dir_fwd_kernel(gi, w_hh, b_hh, h0, compute_dtype)
    t, nd, b, h = _check(gi, w_hh, b_hh, h0, compute_dtype)
    if h > DIR_MAX_HIDDEN:
        raise ValueError(f"gru_recurrence: hidden size {h} > {DIR_MAX_HIDDEN} does not fit the kernel")
    if _fwd_route(h, compute_dtype) == "steps":
        return _dir_fwd_kernel(gi, w_hh, b_hh, h0, compute_dtype)
    w = w_hh.to(compute_dtype).contiguous()
    bias = b_hh.reshape(nd, 3 * h).float().contiguous()
    gi, h0 = gi.contiguous(), h0.contiguous()
    kernels.require_cuda("gru_recurrence", gi, w, bias, h0)
    ys = torch.empty((t, nd, b, h), dtype=torch.float32, device=gi.device)
    if t == 0:
        return ys
    bf16 = compute_dtype == torch.bfloat16
    cn = _cluster_size(h, bf16, gi.device.index)
    lib = kernels.lib()
    with torch.cuda.device(gi.device):
        code = lib.w2vb_gru_fwd_cluster(
            gi.data_ptr(), w.data_ptr(), int(bf16), bias.data_ptr(), h0.data_ptr(), ys.data_ptr(),
            t, nd, b, h, cn, kernels.stream_of(gi),
        )
    kernels.check("gru", code)
    kernels.LAUNCHES["gru"] += 1
    return ys


def _round_up(n, m):
    return (n + m - 1) // m * m


def dir_fwd_weight(w_hh, compute_dtype):
    """W_hh (D, H, 3H) as the per-direction forward kernel takes it: (D, 3 Hp,
    Hp) in the compute dtype, row g Hp + j holding gate g's column j of W_hh
    (K-contiguous), zeros in the padding (Hp = H rounded up to 64)."""
    nd, h, _ = w_hh.shape
    hp = _round_up(h, _DIR_HIDDEN_PAD)
    w = torch.zeros((nd, 3, hp, hp), dtype=compute_dtype, device=w_hh.device)
    w[:, :, :h, :h] = w_hh.to(compute_dtype).reshape(nd, h, 3, h).permute(0, 2, 3, 1)
    return w.reshape(nd, 3 * hp, hp)


def _dir_fwd_kernel(gi, w_hh, b_hh, h0, compute_dtype):
    """The per-direction forward kernel (one launch per step): ys (T, D, B,
    H) f32, any H and B (csrc/gru.cu)."""
    t, nd, b, h = _check(gi, w_hh, b_hh, h0, compute_dtype, multiple_of_32=False)
    cd, dev = compute_dtype, gi.device
    hp, bp = _round_up(h, _DIR_HIDDEN_PAD), _round_up(b, _DIR_BATCH_PAD)
    wt = dir_fwd_weight(w_hh, cd)
    bias = b_hh.reshape(nd, 3 * h).float().contiguous()
    gi, h0 = gi.contiguous(), h0.contiguous()
    kernels.require_cuda("gru_recurrence_dir", gi, wt, bias, h0)
    ys = torch.empty((t, nd, b, h), dtype=torch.float32, device=dev)
    if t == 0:
        return ys
    hc = torch.zeros((2, nd, bp, hp), dtype=cd, device=dev)  # h_cd ping-pong; padding stays 0
    hc[0, :, :b, :h] = h0.to(cd)
    lib = kernels.lib()
    with torch.cuda.device(dev):
        code = lib.w2vb_gru_dir_fwd(
            gi.data_ptr(), wt.data_ptr(), int(cd == torch.bfloat16), bias.data_ptr(), h0.data_ptr(),
            hc.data_ptr(), ys.data_ptr(), t, nd, b, h, bp, hp, kernels.stream_of(gi),
        )
    kernels.check("gru_dir", code)
    kernels.LAUNCHES["gru_dir"] += 1  # once per entry call, not per step launch
    return ys


def _bwd_launch(gi, w_hh, b_hh, h0, ys, g, compute_dtype, fused):
    """The backward's kernels (csrc/gru.cu): gh for every step, then one
    launch per step; fused adds the dW_hh / db_hh kernel. Returns (dgi,
    dW_hh, db_hh, dh0) for the fused entry, (dgi, dgh, dh0) for the
    per-direction one, all f32. W_hh goes in laid out (D, Hp, 3 Hp), each
    gate block padded to Hp columns, zeros in the padding."""
    entry = "gru_recurrence backward" if fused else "gru_recurrence_dir backward"
    t, nd, b, h = _check(gi, w_hh, b_hh, h0, compute_dtype, multiple_of_32=fused)
    if fused and h > FUSED_BWD_MAX_HIDDEN:
        raise ValueError(f"{entry}: hidden size {h} > {FUSED_BWD_MAX_HIDDEN} does not fit the fused entry "
                         "(gru_recurrence_dir takes it)")
    cd, dev = compute_dtype, gi.device
    hp, bp = _round_up(h, _DIR_HIDDEN_PAD), _round_up(b, _DIR_BATCH_PAD)
    w = torch.zeros((nd, hp, 3, hp), dtype=cd, device=dev)
    w[:, :h, :, :h] = w_hh.to(cd).reshape(nd, h, 3, h)
    w = w.reshape(nd, hp, 3 * hp)
    bias = b_hh.reshape(nd, 3 * h).float().contiguous()
    gi, h0, ys, g = (x.float().contiguous() for x in (gi, h0, ys, g))
    kernels.require_cuda(entry, gi, w, bias, h0, ys, g)
    f32 = dict(dtype=torch.float32, device=dev)
    dgi, dh0 = torch.empty_like(gi), torch.empty_like(h0)
    dgh = dw = db = None
    if fused:
        dw, db = torch.empty((nd, h, 3 * h), **f32), torch.empty((nd, 1, 3 * h), **f32)
        outs = (dgi, dw, db, dh0)
    else:
        dgh = torch.empty_like(gi)  # dgi with the n column scaled by r, for dW_hh outside
        outs = (dgi, dgh, dh0)
    if t == 0:
        return tuple(x if x is dgi else x.zero_() for x in outs)
    rp = _round_up(t * bp, _ROW_PAD)
    hpc = torch.empty((t, nd, bp, hp), dtype=cd, device=dev)  # hprev in the compute dtype
    dghc = torch.zeros((2, nd, bp, 3 * hp), dtype=cd, device=dev)  # dgh_cd ping-pong; padding stays 0
    dhz = torch.empty((nd, bp, hp), **f32)  # dh * z carried between steps
    gh = torch.empty((t, nd, bp, 3 * hp), **f32)  # hprev_cd . W_cd, every step
    hpct = dghct = dbp = None
    if fused:
        hpct = torch.empty((nd, hp, rp), dtype=cd, device=dev)  # hpc transposed: the dW product's A
        dghct = torch.empty((nd, 3 * hp, rp), dtype=cd, device=dev)  # dgh_cd of every step, transposed
        dbp = torch.empty((nd, bp, 3 * hp), **f32)  # dgh summed over the steps, per batch row
    ptrs = [None if x is None else x.data_ptr()
            for x in (gi, w, bias, h0, ys, g, hpc, hpct, dghc, dghct, dbp, dhz, gh, dgi, dgh, dw, db, dh0)]
    lib = kernels.lib()
    with torch.cuda.device(dev):
        code = lib.w2vb_gru_bwd(*ptrs[:2], int(cd == torch.bfloat16), *ptrs[2:], t, nd, b, h, bp, hp, rp,
                                kernels.stream_of(gi))
    name = "gru_bwd" if fused else "gru_dir_bwd"
    kernels.check(name, code)
    kernels.LAUNCHES[name] += 1  # once per entry call, not per launch
    return outs


def _bwd_kernel(gi, w_hh, b_hh, h0, ys, g, compute_dtype, per_direction=False):
    """The backward kernels of the fused entry (dW_hh and db_hh in a kernel,
    from the compute-dtype operands), or with per_direction those of
    gru_recurrence_dir (dW_hh and db_hh from gru_dir_dw_db outside):
    (dgi, dW_hh, db_hh, dh0), all f32."""
    if not per_direction:
        return _bwd_launch(gi, w_hh, b_hh, h0, ys, g, compute_dtype, fused=True)
    dgi, dgh, dh0 = _dir_bwd_recurrence(gi, w_hh, b_hh, h0, ys, g, compute_dtype)
    dw, db = gru_dir_dw_db(h0, ys, dgh)
    return dgi, dw, db, dh0


def _dir_bwd_recurrence(gi, w_hh, b_hh, h0, ys, g, compute_dtype):
    """The per-direction backward's kernels: (dgi, dgh, dh0), f32."""
    return _bwd_launch(gi, w_hh, b_hh, h0, ys, g, compute_dtype, fused=False)


class _GruRecurrence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gi, w_hh, b_hh, h0, compute_dtype, per_direction):
        if gi.is_cuda:
            ys = _fwd_kernel(gi, w_hh, b_hh, h0, compute_dtype, per_direction)
        else:
            ys = gru_recurrence_plain(gi, w_hh, b_hh, h0, compute_dtype)
        # the backward recomputes the gates from ys, as the JAX _vjp_fwd saves it
        ctx.save_for_backward(gi, w_hh, b_hh, h0, ys)
        ctx.args = (compute_dtype, per_direction)
        return ys

    @staticmethod
    def backward(ctx, g):
        gi, w_hh, b_hh, h0, ys = ctx.saved_tensors
        fn = _bwd_kernel if gi.is_cuda else gru_recurrence_bwd_plain
        dgi, dw, db, dh0 = fn(gi, w_hh, b_hh, h0, ys, g, *ctx.args)
        return dgi, dw.to(w_hh.dtype), db.reshape(b_hh.shape).to(b_hh.dtype), dh0, None, None


def gru_recurrence(gi, w_hh, b_hh, h0, compute_dtype=torch.float32):
    """Same contract as gru_recurrence_plain; differentiable in gi, w_hh,
    b_hh and h0. On CUDA tensors the kernels run (or raise); on CPU tensors
    their plain versions."""
    return _GruRecurrence.apply(gi, w_hh, b_hh, h0, compute_dtype, False)


def gru_recurrence_dir(gi, w_hh, b_hh, h0, compute_dtype=torch.float32):
    """gru_recurrence with the per-direction variant's kernels and its f32
    dW_hh product (counterpart of the JAX gru_recurrence_dir; see the
    module docstring). Any H and B on CUDA tensors."""
    return _GruRecurrence.apply(gi, w_hh, b_hh, h0, compute_dtype, True)
