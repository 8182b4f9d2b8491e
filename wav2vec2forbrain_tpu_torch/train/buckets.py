"""Length buckets: the per-batch time widths of --length_buckets
(counterpart of wav2vec2forbrain_tpu/train/device_cache.py's bucket grid:
build_split_caches, DeviceDatasetCache.set_buckets, width_for and
reachable_widths).

With --device_data_cache on, every batch of a split runs at the split's
dataset-wide width; --length_buckets lets a batch run at the smallest
width of a grid that covers its longest sample instead:

- an integer N: up to N widths, the (i + 1) / N quantiles of the sample
  lengths of all cached splits, rounded up to --pad_to_multiple (fewer
  than 2 turns the grid off);
- "exact": every --pad_to_multiple width a sample needs, so that each
  batch runs at its streaming collate's width and a padding-sensitive
  model (the biGRU reads padded frames) sees the streaming numerics.

The grid is shared across splits; each split's list is clipped to its own
dataset-wide width and always ends with it. Lengths are in input frames
(before the unfold).

`chunk_order` is the order in which the JAX package's K-step chunked
epochs visit a split's batches (its train_loop.py::_chunk_work_plan).
"""

from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from wav2vec2forbrain_tpu_torch.util.seq import round_up


def bucket_grid(lengths: Sequence[int], length_buckets: Union[int, str], pad_to_multiple: int) -> Optional[List[int]]:
    """The shared grid of widths from the lengths of every cached split, or
    None where bucketing is off."""
    if length_buckets == "off" or len(lengths) == 0:
        return None
    lens = np.asarray(lengths, np.float64)
    if length_buckets == "exact":
        return sorted({round_up(int(n), pad_to_multiple) for n in np.unique(lens)})
    n = int(length_buckets)
    if n < 2:
        return None
    return sorted({round_up(int(np.quantile(lens, (i + 1) / n)), pad_to_multiple) for i in range(n)})


def split_buckets(grid: Sequence[int], t_full: int) -> List[int]:
    """One split's widths: the grid clipped to the split's dataset-wide
    width, which always ends the list."""
    widths = sorted({min(int(b), t_full) for b in grid})
    if widths[-1] < t_full:
        widths.append(t_full)
    return widths


def width_for(buckets: Sequence[int], longest: int) -> int:
    """The smallest width that covers a batch's longest sample."""
    for b in buckets:
        if b >= longest:
            return b
    return buckets[-1]


def reachable_widths(buckets: Sequence[int], lengths: Sequence[int]) -> List[int]:
    """Every width a batch of a split with these sample lengths can run at."""
    return sorted({width_for(buckets, int(n)) for n in np.unique(np.asarray(lengths))})


def plan_buckets(lengths: Dict[str, Sequence[int]], t_full: Dict[str, int], length_buckets: Union[int, str],
                 pad_to_multiple: int) -> Dict[str, List[int]]:
    """{split: its widths} for the cached splits (lengths and dataset-wide
    widths by split), {} where bucketing is off."""
    grid = bucket_grid([n for lens in lengths.values() for n in lens], length_buckets, pad_to_multiple)
    if not grid:
        return {}
    return {split: split_buckets(grid, t_full[split]) for split in lengths}


def chunk_order(widths: Sequence[int], grouped: bool) -> List[int]:
    """The batch order of a chunked JAX epoch, from each batch's width in
    the loader's order: stably sorted by width where `grouped` (so each
    width is one run of chunks), else the loader's order. Chunks keep the
    order of the batches they hold, and a run's padded tail is skipped."""
    order = list(range(len(widths)))
    if grouped:
        order.sort(key=lambda i: widths[i])
    return order
