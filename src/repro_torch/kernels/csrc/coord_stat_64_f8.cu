// coord_stat for 64-row register capacity, fp8 e4m3 code input: K18's
// scaled and K19's scaled masked instance (one translation unit per
// capacity and dtype: they compile in parallel).
#include "coord_stat.cuh"

template RT_CS_LAUNCH(64, __nv_fp8_e4m3, false, true);
template RT_CS_LAUNCH(64, __nv_fp8_e4m3, true, true);
