// The order in which the tile kernels (flash_attn_fwd, flash_attn_fwd_tc)
// walk their q tiles. blockIdx.y is the launch order: the hardware hands
// out blocks with bh (blockIdx.x) fastest, then blockIdx.y. Under a causal
// mask q tile t sees t+1 tiles of keys, so the last tile is the heaviest;
// launching it first keeps the long blocks off the tail of the run, where
// they would set its length while most SMs idle. Without a mask every tile
// costs the same and the order is the identity.
//
// Mirrored by brpc_tpu_torch/ops/flash_attention.py `_causal_tile_order`.
#pragma once

__device__ __forceinline__ int causal_tile(int launch_index, int n_tiles,
                                           int causal) {
  return causal ? n_tiles - 1 - launch_index : launch_index;
}
