// The fused ABC simulation kernel (abc_sim.cuh) for the seir model
// (seir.cuh): the exports abc_sim_distance_seir and abc_sim_wave_seir. One
// translation unit a model, so that nvcc builds the models side by side.
//
// Replaces the TPU kernel src/repro/kernels/abc_sim.py:138 (_kernel) for
// this model's rows.

#include "abc_sim.cuh"
#include "seir.cuh"

ABC_SIM_EXPORTS(seir, Seir)
