// The region axis of the fused ABC simulation kernel for Li et al. 2020's
// cities (li2020.cuh): the tile route alone (abc_sim_regional_tile.cuh, a
// tile of samples a block, where its design is described), the exports
// abc_sim_regional_{distance,wave}_tile_li2020. The thread and warp routes
// take neither inflow nor outflow rows, populations a region nor region
// constants, so this unit does not build them.
//
// No TPU kernel computes this model; it replaces none.

#include "abc_sim_regional_tile.cuh"
#include "li2020.cuh"

ABC_SIM_REGIONAL_LAYOUT_EXPORTS(li2020, Li2020)
ABC_SIM_REGIONAL_TILE_EXPORTS(li2020, Li2020)
