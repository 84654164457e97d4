// The fused ABC simulation kernel (abc_sim.cuh) for the seiard model
// (seiard.cuh): the exports abc_sim_distance_seiard and abc_sim_wave_seiard. One
// translation unit a model, so that nvcc builds the models side by side.
//
// Replaces the TPU kernel src/repro/kernels/abc_sim.py:138 (_kernel) for
// this model's rows.

#include "abc_sim.cuh"
#include "seiard.cuh"

ABC_SIM_EXPORTS(seiard, Seiard)
