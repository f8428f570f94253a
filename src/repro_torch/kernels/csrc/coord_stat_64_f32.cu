// coord_stat for 64-row register capacity, float input: K1's
// plain and K5's masked instance (one translation unit per capacity
// and dtype: they compile in parallel).
#include "coord_stat.cuh"

template RT_CS_LAUNCH(64, float, false, false);
template RT_CS_LAUNCH(64, float, true, false);
