"""Device-resident dataset cache: upload a split once, gather each batch on
the device (counterpart of wav2vec2forbrain_tpu/train/device_cache.py).

A split's features (at the --h2d_dtype wire dtype), token ids, lengths and
day indices are planned in one host pass (data/dataset.py::split_pass),
padded to the split's dataset-wide (T, U), and uploaded to the
experiment's device once. Each step then sends a row of batch indices and
its mask (a few hundred bytes, one copy from one reused pinned buffer) and
gathers its batch with `index_select` on the device, instead of collating,
padding and copying the features from the host.

Semantics against the streamed path (train/train_loop.py::Trainer._place):
- the batches and their order are the same: both read the loader's
  iter_index_batches (the same shuffle stream), and an epoch the JAX
  package would chunk visits them in the same chunk order;
- the padding contract is `_place`'s: rows padded to --batch_size rounded
  up to the data axis with masked duplicates of the last index
  (`padded_index_row`), each split at its dataset-wide (T, U), and with
  --length_buckets the time axis at the bucket of the batch's longest
  sample, which the gather reads from the [:, :t] view of the time axis
  (only that bucket's bytes). A gathered batch is bitwise `_place`'s;
- the evaluators read `host_batch`: the true rows of host copies of the
  same targets and lengths, features left out.

Where it differs from the JAX package: an upload that fails raises with
its reason (the JAX package streams instead), and `reachable_widths` is
left out: it serves only the JAX package's --precompile_buckets, which has
no counterpart in the port.
"""

import time
from typing import List, Optional

import numpy as np
import torch

from wav2vec2forbrain_tpu_torch.data.batch import B2tBatch
from wav2vec2forbrain_tpu_torch.data.dataset import split_pass, time_axis_of
from wav2vec2forbrain_tpu_torch.parallel.mesh import padded_rows
from wav2vec2forbrain_tpu_torch.train.buckets import plan_buckets, split_buckets, width_for
from wav2vec2forbrain_tpu_torch.util import profiling
from wav2vec2forbrain_tpu_torch.util.seq import calc_seq_len

WIRE_DTYPES = {"float32": torch.float32, "float16": torch.float16, "bfloat16": torch.bfloat16}


def padded_index_row(idxs: List[int], batch_size: int, data_axis: int = 1):
    """(idx_row, mask_row, true_b): a batch's indices padded up to
    --batch_size rounded up to the data axis, the padding rows duplicating
    the last index with mask 0: Trainer._place's padding contract as an
    index row (int32) and its mask (float32)."""
    true_b = len(idxs)
    pad = padded_rows(batch_size, true_b, data_axis) - true_b
    idx = np.asarray(list(idxs) + [idxs[-1]] * pad, np.int32)
    mask = np.concatenate([np.ones((true_b,), np.float32), np.zeros((pad,), np.float32)])
    return idx, mask, true_b


class DeviceDatasetCache:
    """One split's samples as tensors on a device, and its batch gather."""

    def __init__(self, feats: torch.Tensor, targets: np.ndarray, day_idxs: np.ndarray, input_lens: np.ndarray,
                 target_lens: np.ndarray, time_axis: int = 0):
        """feats: (N, T, C) (or (N, ch, T, F) in the multichannel layouts,
        time_axis 1) at the wire dtype on the host; the rest int32 numpy."""
        self._host_feats = feats  # dropped by upload()
        self.targets = targets
        self.day_idxs = day_idxs
        self.input_lens = input_lens
        self.target_lens = target_lens
        self.time_axis = time_axis
        self.t_full = feats.shape[1 + time_axis]
        self.u_full = targets.shape[1]
        self.buckets: Optional[List[int]] = None
        self.upload_s: Optional[float] = None
        self._dev = None
        self._device = None
        self._pinned = None  # the index row's host buffer (on a card)
        self._copied = None  # the event after its last copy

    # --- construction -------------------------------------------------------

    @classmethod
    def plan(cls, dataset, tokenizer, pad_to_multiple: int = 1, target_pad_to_multiple: int = 1,
             wire_dtype: str = "float32") -> Optional["DeviceDatasetCache"]:
        """The host stage: every sample padded to the split's dataset-wide
        (T, U), the features at the wire dtype. None for an empty split.
        `nbytes` is exact from here on, so a budget can be checked before
        anything is uploaded."""
        split = split_pass(dataset, tokenizer, pad_to_multiple, target_pad_to_multiple)
        if split is None:
            return None
        samples, lengths, t_max, targets = split
        time_axis = time_axis_of(dataset.config.preprocessing)
        shape = list(samples[0].input.shape)
        shape[time_axis] = t_max
        feats = torch.zeros((len(samples), *shape), dtype=WIRE_DTYPES[wire_dtype])
        for row, s, n in zip(feats, samples, lengths):
            # the f32 values cast as the collate's batch is (Trainer._place)
            row.narrow(time_axis, 0, n).copy_(torch.from_numpy(np.asarray(s.input, np.float32)))
        return cls(
            feats=feats,
            targets=targets,
            day_idxs=np.asarray([s.day_idx for s in samples], np.int32),
            input_lens=np.asarray(lengths, np.int32),
            target_lens=np.asarray([calc_seq_len(row) for row in targets], np.int32),
            time_axis=time_axis,
        )

    @property
    def nbytes(self) -> int:
        feats = self._host_feats if self._dev is None else self._dev[0]
        return int(feats.numel() * feats.element_size() + self.targets.nbytes + self.day_idxs.nbytes
                   + self.input_lens.nbytes + self.target_lens.nbytes)

    def upload(self, device) -> "DeviceDatasetCache":
        """Move the planned arrays to `device` (a replica on each rank under
        data or tensor parallelism) and free the host features. Waits for
        the copies, so a device fault raises here, not in the first step."""
        self._device = torch.device(device)
        t = time.perf_counter()
        self._dev = tuple(
            a.to(self._device) for a in (self._host_feats, *(torch.from_numpy(h) for h in (
                self.targets, self.day_idxs, self.input_lens, self.target_lens)))
        )
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        self.upload_s = time.perf_counter() - t
        self._host_feats = None
        return self

    # --- length buckets -------------------------------------------------------

    def set_buckets(self, t_buckets: Optional[List[int]]) -> "DeviceDatasetCache":
        """Gather each batch at the smallest of these widths that covers its
        longest sample (clipped to the split's width, which always ends the
        list); None: every batch at the split's width."""
        self.buckets = split_buckets(t_buckets, self.t_full) if t_buckets else None
        return self

    def width_for(self, idxs: List[int]) -> int:
        """A batch's time width: its bucket, or the split's width."""
        if self.buckets is None:
            return self.t_full
        return width_for(self.buckets, int(self.input_lens[np.asarray(idxs, np.int64)].max()))

    # --- per-step gathers -----------------------------------------------------

    def _index_row(self, idx: np.ndarray, mask: np.ndarray):
        """The index row and its mask on the device. On a card both go in one
        asynchronous copy from one pinned buffer, rewritten only once its last
        copy has run."""
        if self._device.type != "cuda":
            return torch.from_numpy(idx), torch.from_numpy(mask)
        rows = len(idx)
        if self._pinned is None or self._pinned.numel() < 2 * rows:
            self._pinned = torch.empty(2 * rows, dtype=torch.int32, pin_memory=True)
        elif self._copied is not None:
            self._copied.synchronize()
        buf = self._pinned[: 2 * rows]
        buf[:rows].copy_(torch.from_numpy(idx))
        buf[rows:].view(torch.float32).copy_(torch.from_numpy(mask))
        dev = buf.to(self._device, non_blocking=True)
        self._copied = torch.cuda.Event()
        self._copied.record()
        return dev[:rows], dev[rows:].view(torch.float32)

    def device_batch(self, idx: np.ndarray, mask: np.ndarray, t_width: Optional[int] = None) -> B2tBatch:
        """The rows `idx` (int32) with sample_mask `mask`, the time axis at
        t_width (the split's width by default)."""
        idx_t, mask_t = self._index_row(idx, mask)
        feats, targets, day, ilens, tlens = self._dev
        t = self.t_full if t_width is None else t_width
        x = feats.narrow(1 + self.time_axis, 0, t).index_select(0, idx_t)
        return B2tBatch(x, targets.index_select(0, idx_t), day.index_select(0, idx_t), ilens.index_select(0, idx_t),
                        tlens.index_select(0, idx_t), mask_t)

    def host_batch(self, idxs: List[int]) -> B2tBatch:
        """The evaluators' view: the true rows, features left out."""
        sel = np.asarray(idxs, np.int64)
        return B2tBatch(None, self.targets[sel], self.day_idxs[sel], self.input_lens[sel], self.target_lens[sel],
                        np.ones((len(idxs),), np.float32))

    def stream(self, index_batches, batch_size: int, shard=None):
        """(device batch, true rows, mask_total, host batch) for each index
        batch, as Trainer._place gives them: under data parallelism
        (`shard`, parallel/mesh.py::DataShard) the width comes from the whole
        global batch, mask_total is the global mask row's sum and the batch
        holds this rank's rows; in one process mask_total is None. Each
        batch's gather is an `input_wait` span (util/profiling.py)."""
        dp = 1 if shard is None else shard.size
        for k, idxs in enumerate(index_batches):
            with profiling.span("input_wait", k):
                idx, mask, true_b = padded_index_row(idxs, batch_size, dp)
                width = self.width_for(idxs)
                mask_total = None
                if shard is not None:
                    mask_total = float(mask.sum())
                    mine = shard.rows(len(idx))
                    idx, mask = idx[mine], mask[mine]
                item = self.device_batch(idx, mask, width), true_b, mask_total, self.host_batch(idxs)
            yield item


def build_split_caches(loaders: dict, tokenizer, config, device, max_bytes: Optional[int] = None,
                       verbose: bool = True) -> dict:
    """{split: DeviceDatasetCache} for {split: DataLoader}: plan every
    split, check the byte budget (`max_bytes`, None for none), upload, and
    lay the --length_buckets grid over the splits. Over the budget every
    split streams ({}, with a line that says why); an upload that fails
    raises with its reason."""
    plans = {}
    for split, loader in loaders.items():
        plan = DeviceDatasetCache.plan(loader.dataset, tokenizer, config.pad_to_multiple,
                                       config.target_pad_to_multiple, config.h2d_dtype)
        if plan is not None:
            plans[split] = plan
    total = sum(p.nbytes for p in plans.values())
    if max_bytes is not None and total > max_bytes:
        if verbose:
            print(f"device_data_cache: {total / 1e6:.0f} MB exceeds the {max_bytes / 1e6:.0f} MB budget; "
                  "streaming instead (batches at the collate's width)")
        return {}
    for split, plan in plans.items():
        try:
            plan.upload(device)
        except RuntimeError as e:
            raise RuntimeError(f"device_data_cache: uploading the {split} split ({plan.nbytes / 1e6:.0f} MB) to "
                               f"{device} failed: {e}") from e
    if config.length_buckets != "off":
        grid = plan_buckets({s: p.input_lens for s, p in plans.items()}, {s: p.t_full for s, p in plans.items()},
                            config.length_buckets, config.pad_to_multiple)
        for split, widths in grid.items():
            plans[split].set_buckets(widths)
        if grid and verbose:
            print(f"device_data_cache: length buckets (frames) {sorted({w for b in grid.values() for w in b})}")
    if plans and verbose:
        print("device_data_cache: resident on " + str(device) + ": " + ", ".join(
            f"{s} {p.nbytes / 1e6:.1f} MB at (T, U) ({p.t_full}, {p.u_full}) in {p.upload_s:.3f} s"
            for s, p in plans.items()) + "; each step sends an index row")
    return plans
