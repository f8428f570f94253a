// coord_stat for 64-row register capacity, int8 code input: K18's
// scaled and K19's scaled masked instance (one translation unit per
// capacity and dtype: they compile in parallel).
#include "coord_stat.cuh"

template RT_CS_LAUNCH(64, int8_t, false, true);
template RT_CS_LAUNCH(64, int8_t, true, true);
