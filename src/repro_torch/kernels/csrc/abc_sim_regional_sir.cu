// The region axis of the fused ABC simulation kernel (abc_sim_regional.cuh,
// where its design is described) for the sir struct (sir.cuh): the exports
// abc_sim_regional_distance_sir and abc_sim_regional_wave_sir. One
// translation unit a struct, so that nvcc builds them side by side with the
// flat ones (abc_sim_<model>.cu), which this file leaves as they are.
//
// Replaces the region axis of the TPU kernel src/repro/kernels/abc_sim.py:138
// (_kernel) for this model's rows.

#include "abc_sim_regional.cuh"
#include "sir.cuh"

ABC_SIM_REGIONAL_EXPORTS(sir, Sir)
