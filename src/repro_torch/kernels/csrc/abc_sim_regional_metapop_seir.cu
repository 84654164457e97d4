// The region axis of the fused ABC simulation kernel (abc_sim_regional.cuh,
// where its design is described) for the metapop_seir struct (metapop_seir.cuh): the exports
// abc_sim_regional_distance_metapop_seir and abc_sim_regional_wave_metapop_seir. One
// translation unit a struct, so that nvcc builds them side by side with the
// flat ones (abc_sim_<model>.cu), which this file leaves as they are.
//
// Replaces the region axis of the TPU kernel src/repro/kernels/abc_sim.py:138
// (_kernel) for this model's rows.

#include "abc_sim_regional.cuh"
#include "metapop_seir.cuh"

ABC_SIM_REGIONAL_EXPORTS(metapop_seir, MetapopSeir)
