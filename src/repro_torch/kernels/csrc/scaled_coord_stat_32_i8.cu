// The scaled coordinate statistic (K18 and K19) for a 32-row register
// capacity, int8 codes (one translation unit per capacity and code type:
// they compile in parallel).
#include "scaled_coord_stat.cuh"

template RT_SCS_LAUNCH(32, int8_t, false);
template RT_SCS_LAUNCH(32, int8_t, true);
