"""The SASS reader behind ``python -m repro_torch.kernels.sass`` on
text in ``cuobjdump -sass`` and ``ptxas -v`` form (the tools themselves
run only where the CUDA toolkit is)."""
from repro_torch.kernels import sass

SASS = """
\tcode for sm_90a
\t\tFunction : _Z6kernelPf
\t.headerflags\t@"EF_CUDA_SM90"
        /*0000*/        LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */
                                                 /* 0x000fe40000000800 */
        /*0010*/        S2R R0, SR_CTAID.X ;     /* 0x0000000000007919 */
        /*0020*/                   FMNMX R2, R3, R4, PT ;
        /*0030*/                   FMNMX R5, R3, R4, !PT ;
        /*0040*/              @!P1 BRA 0x20 ;
        /*0050*/                   LDG.E.128 R4, desc[UR4][R2.64] ;
        /*0060*/               @P0 BRA 0x10 ;
        /*0070*/                   EXIT ;
        /*0080*/                   BRA 0x80;
        /*0090*/                   NOP;
\t\tFunction : _Z5otherv
        /*0000*/                   EXIT ;
"""

PTXAS = """ptxas info    : Compiling entry function '_Z1kv' for 'sm_90a'
ptxas info    : Function properties for _Z1kv
    0 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 1288 bytes smem
ptxas info    : Function properties for _Z2exv
    264 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
"""


def test_functions_drop_padding_and_keep_opcodes():
    funcs = sass.functions(SASS)
    assert list(funcs) == ["_Z6kernelPf", "_Z5otherv"]
    ops = [op for _, op, _ in funcs["_Z6kernelPf"]]
    assert ops == ["LDC", "S2R", "FMNMX", "FMNMX", "BRA", "LDG.E.128",
                   "BRA", "EXIT", "BRA"]
    assert [op for _, op, _ in funcs["_Z5otherv"]] == ["EXIT"]


def test_loops_nest_and_skip_the_exit_trap():
    loops = sass.loops(sass.functions(SASS)["_Z6kernelPf"])
    assert [(lp["start"], lp["end"]) for lp in loops] == [("0x20", "0x40"),
                                                           ("0x10", "0x60")]
    inner, outer = loops
    assert (inner["instructions"], inner["flat"]) == (3, 3)
    assert inner["ops"] == {"FMNMX": 2, "BRA": 1}
    # the outer loop less the inner one: S2R, LDG and its own branch
    assert (outer["instructions"], outer["flat"]) == (6, 3)
    assert outer["ops"] == {"S2R": 1, "LDG": 1, "BRA": 1}


def test_ptxas_figures_by_function():
    figs = sass.ptxas_figures(PTXAS)
    assert figs["_Z1kv"] == {"spill_stores": 4, "spill_loads": 8,
                             "registers": 64, "smem_bytes": 1288}
    assert figs["_Z2exv"] == {"spill_stores": 0, "spill_loads": 0}
