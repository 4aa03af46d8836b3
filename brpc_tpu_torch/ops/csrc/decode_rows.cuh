// How flash_decode cuts a sequence's valid cache rows over its blocks.
// The grid gives every sequence `splits` blocks (gridDim.y), chosen on the
// host from the shapes alone; the lengths live on the device, so the cut is
// made here. Sequence b uses live = min(splits, ceil(len / min_rows)) of
// its blocks and cuts its len valid rows evenly among them: each takes
// base = len / live rows and the first len % live one more, in order, so
// block `split` starts where the blocks before it end. A block past `live`
// takes no row (rows 0) and exits at once; with len 0 no block is live.
// Every step is a plain statement on non-negative ints, so that
// brpc_tpu_torch/ops/flash_attention.py `_decode_rows`, its mirror, can be
// held to this text by the CPU tests.
#pragma once

struct DecodeRows {
  int live;    // blocks of the sequence that take rows
  int first;   // this block's first cache row
  int rows;    // this block's rows, 0 past the live blocks
};

__device__ __forceinline__ DecodeRows decode_rows(int len, int splits,
                                                  int min_rows, int split) {
  const int live = min(splits, (len + min_rows - 1) / min_rows);
  const int base = len / max(live, 1);
  const int extra = len % max(live, 1);
  const int first = split * base + min(split, extra);
  const int rows = (split < live) * (base + (split < extra));
  return {live, first, rows};
}
