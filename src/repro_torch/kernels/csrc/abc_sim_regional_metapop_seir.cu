// The region axis of the fused ABC simulation kernel, all three routes
// (abc_sim_regional.cuh, one thread a sample, abc_sim_regional_warp.cuh,
// one warp a sample, and abc_sim_regional_tile.cuh, a tile of samples a
// block, where their designs are described) for the metapop_seir
// struct (metapop_seir.cuh): the exports
// abc_sim_regional_{distance,wave}_metapop_seir and their `_warp` and `_tile` twins. One
// translation unit a struct, so that nvcc builds them side by side with the
// flat ones (abc_sim_<model>.cu), which this file leaves as they are.
//
// Replaces the region axis of the TPU kernel src/repro/kernels/abc_sim.py:138
// (_kernel) for this model's rows.

#include "abc_sim_regional_tile.cuh"
#include "metapop_seir.cuh"

ABC_SIM_REGIONAL_EXPORTS(metapop_seir, MetapopSeir)
ABC_SIM_REGIONAL_WARP_EXPORTS(metapop_seir, MetapopSeir)
ABC_SIM_REGIONAL_TILE_EXPORTS(metapop_seir, MetapopSeir)
