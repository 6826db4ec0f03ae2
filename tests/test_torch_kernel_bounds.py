"""chip_smoke.kernel_bounds against counts made by hand, the attention
timing script's shapes and refusal without a card, and the dump floor
script's loops and floor on a made-up disassembly (no card needed).

The bound is the larger of operations over the H100's peak for their type
(989 TFLOP/s bf16, 67 fp32) and bytes over 3.35 TB/s, each input byte read
once and each output byte written once.
"""

import pytest

import chip_smoke
from turkish_asr_torch.scripts import ab_attention, dump_floor

TRAIN = dict(B=32, H=4, Kh=1, T=200, D=64)
SERVE = dict(B=16, H=4, Kh=1, T=601, D=64)


@pytest.mark.parametrize("name,shape,flops,nbytes,bound_by", [
    # q 3.2768 MB + k, v 1.6384 MB bf16, mask 6400 B; out 6.5536 MB and
    # lse, m, l 0.3072 MB fp32: 11.78 MB, 4*B*H*T^2*D = 1.311 GFLOP.
    ("flash_attention_fwd", TRAIN, 1_310_720_000, 11_782_400, "bytes"),
    # + g 6.5536 MB, m, l, delta 0.3072 MB; dq 6.5536 MB, dk, dv 3.2768 MB:
    # 21.6 MB, 10*B*H*T^2*D = 3.28 GFLOP.
    ("flash_attention_bwd", TRAIN, 3_276_800_000, 21_612_800, "bytes"),
    ("flash_attention_fwd", SERVE, 5_917_917_184, 17_703_056, "operations"),
    ("flash_attention_bwd", SERVE, 14_794_792_960, 32_473_232, "operations"),
    # the (4, 4, 801, 801) uint8 keep mask
    ("dropout_mask", dict(B=4, H=4, T=801), 0, 10_265_616, "bytes"),
    # S = 129: lp 1.4336 MB, targets 8192 (int32), lengths 256; alpha
    # 3.3024 MB, nll 128; 10 ops per lane-frame
    ("ctc_fwd", dict(B=32, T=200, L=64, V=56), 8_256_000, 4_744_576, "bytes"),
    # + alpha, nll, cot; grad 1.4336 MB
    ("ctc_bwd", dict(B=32, T=200, L=64, V=56), 16_512_000, 6_178_304, "bytes"),
    # x 3.2768 MB, w1 1.048576 MB, w2 0.524288 MB, b1 8192, b2 1024, y
    # 3.2768 MB; 6*M*C*F
    ("swiglu_fwd", dict(M=6400, C=256, F=1024), 10_066_329_600, 8_135_680, "operations"),
])
def test_kernel_bounds_match_the_hand_counts(name, shape, flops, nbytes, bound_by):
    got = chip_smoke.kernel_bounds(name, **shape)
    assert (got["flops"], got["bytes"], got["bound_by"]) == (flops, nbytes, bound_by)
    peak = 67e12 if name.startswith(("ctc", "dropout")) else 989e12
    assert got["bound_ms"] == pytest.approx(1e3 * max(flops / peak, nbytes / 3.35e12), rel=1e-12)


def test_attention_bounds_in_microseconds():
    """The training step's forward and backward are bound by their bytes
    (3.52 and 6.45 us); the served forward by its flops (5.98 us)."""
    assert chip_smoke.kernel_bounds("flash_attention_fwd", **TRAIN)["bound_ms"] == \
        pytest.approx(3.517e-3, abs=1e-6)
    assert chip_smoke.kernel_bounds("flash_attention_bwd", **TRAIN)["bound_ms"] == \
        pytest.approx(6.452e-3, abs=1e-6)
    assert chip_smoke.kernel_bounds("flash_attention_fwd", **SERVE)["bound_ms"] == \
        pytest.approx(5.984e-3, abs=1e-6)


def test_fp32_attention_inputs_are_held_to_the_fp32_rate():
    got = chip_smoke.kernel_bounds("flash_attention_fwd", dtype="fp32", **SERVE)
    assert got["bound_by"] == "operations"
    assert got["bound_ms"] == pytest.approx(1e3 * 5_917_917_184 / 67e12)


def test_unknown_kernel_is_refused():
    with pytest.raises(ValueError, match="no bound"):
        chip_smoke.kernel_bounds("softmax", B=1)


def test_ab_attention_shapes_cover_the_attention_phase_and_the_main_path():
    """The sweep, the main path's two shapes and bench config 5's two
    (chip_smoke's LONGFORM_ATTENTION), so the parent/change A/B covers
    T'=1601."""
    labels = [label for label, _ in ab_attention._shapes()]
    assert len(labels) == 2 * 2 * 4 * 2 + 2 + 2
    shapes = dict(ab_attention._shapes())
    assert shapes["main path train: bf16 B=32 Kh=1 T'=200 rate=0.1"]["B"] == 32
    assert ab_attention.LONGFORM == chip_smoke.LONGFORM_ATTENTION
    for where, shp in chip_smoke.LONGFORM_ATTENTION.items():
        got = shapes[f"main path {where}: bf16 B={shp['B']} Kh=1 T'=1601 rate={shp['rate']}"]
        assert got == dict(shp, dtype=got["dtype"]) and str(got["dtype"]) == "torch.bfloat16"


ATTENTION_SASS = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_116flash_fwd_kernelI13__nv_bfloat16Li64ELb0EEEv14CUtensorMap_st
        /*0000*/                   UTMALDG.3D [UR8], [UR4] ;
        /*0010*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;
        /*0020*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR8], R24 ;
        /*0030*/                   EXIT ;
		Function : _ZN12_GLOBAL__N_114flash_bwd_dkdvI13__nv_bfloat16Li64ELb1EEEv14CUtensorMap_st
        /*0000*/                   UTMALDG.3D [UR8], [UR4] ;
        /*0010*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0020*/                   EXIT ;
		Function : _ZN12_GLOBAL__N_112flash_bwd_dqIfLi64EEEv14CUtensorMap_stS1_NS_6ParamsE
        /*0000*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0010*/                   EXIT ;
		Function : _ZN12_GLOBAL__N_120flash_bwd_sum_chunksEPK6float4PS0_S3_im
        /*0000*/                   EXIT ;
"""


def test_attention_sass_counts_wgmma_mma_and_tma_loads():
    """chip_smoke's SASS check on a made-up disassembly: HGMMA, HMMA and
    UTMALDG by function, their modifiers dropped."""
    counts = chip_smoke.sass_counts(ATTENTION_SASS)
    assert list(counts.values()) == [{"HGMMA": 2, "HMMA": 0, "UTMALDG": 1},
                                     {"HGMMA": 0, "HMMA": 1, "UTMALDG": 1},
                                     {"HGMMA": 0, "HMMA": 1, "UTMALDG": 0},
                                     {"HGMMA": 0, "HMMA": 0, "UTMALDG": 0}]


def test_attention_sass_check_names_bf16_instances_without_wgmma():
    """Only bf16 forward, dk/dv and dq instances must hold wgmma and TMA
    loads: the fp32 dq and the chunk sum are not held to it."""
    missing = chip_smoke.wgmma_missing(chip_smoke.sass_counts(ATTENTION_SASS))
    assert missing == ["_ZN12_GLOBAL__N_114flash_bwd_dkdvI13__nv_bfloat16Li64ELb1EEEv14CUtensorMap_st"]


def test_ab_attention_needs_a_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        ab_attention.main([])


SASS = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_121dump_keep_mask_kernelIjEEvPhT_iijj
\t.headerflags\t@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;     /* 0x00000a00ff017b82 */
                                                              /* 0x000fe40000000800 */
.L_x_1:
        /*0010*/                   IMAD.MOV.U32 R2, RZ, RZ, R3 ;
        /*0020*/                   LOP3.LUT R4, R2, 0x1, RZ, 0x3c, !PT ;
        /*0030*/              @!P0 BRA `(.L_x_3) ;
.L_x_2:
        /*0040*/                   STG.E.U8 desc[UR4][R6.64], R4 ;
        /*0050*/                   IADD3 R6, R6, 0x1, RZ ;
        /*0060*/               @P1 BRA `(.L_x_2) ;
.L_x_3:
        /*0070*/                   SHF.R.U32.HI R5, RZ, 0x10, R4 ;
        /*0080*/                   STG.E.128 desc[UR4][R8.64], R4 ;
        /*0090*/               @P2 BRA `(.L_x_1) ;
.L_x_4:
        /*00a0*/                   ISETP.GE.U32.AND P0, PT, R2, R3, PT ;
        /*00b0*/               @P0 BRA 0xa0 ;
        /*00c0*/                   EXIT ;
\t\tFunction : _ZN12_GLOBAL__N_121dump_keep_mask_kernelImEEvPhT_iijj
        /*0000*/                   LDC R1, c[0x0][0x28] ;
.L_x_9:
        /*0010*/                   LOP3.LUT R4, R2, 0x1, RZ, 0x3c, !PT ;
        /*0020*/                   LOP3.LUT R4, R4, 0x1, RZ, 0x3c, !PT ;
        /*0030*/                   BRA.U !UP0, `(.L_x_8) ;
        /*0040*/                   STG.E.U8 desc[UR4][R8.64], R4 ;
.L_x_8:
        /*0050*/                   SEL R5, R4, RZ, P0 ;
        /*0060*/                   STG.E.128 desc[UR4][R8.64], R4 ;
        /*0070*/               @P2 BRA `(.L_x_9) ;
        /*0080*/                   EXIT ;
"""


def test_dump_floor_counts_each_outermost_loop():
    """cuobjdump's text: a loop is a backward branch and the instructions
    from its target up to it; its pass through the 16-byte store takes the
    forward branch that skips the byte stores (the nested loop). IMAD (the
    FMA pipe) is not an ALU instruction, LOP3, IADD3, SHF and ISETP are;
    branches by label and by address resolve."""
    functions = dump_floor.parse_sass(SASS)
    assert list(functions) == ["_ZN12_GLOBAL__N_121dump_keep_mask_kernelIjEEvPhT_iijj",
                               "_ZN12_GLOBAL__N_121dump_keep_mask_kernelImEEvPhT_iijj"]
    first = functions["_ZN12_GLOBAL__N_121dump_keep_mask_kernelIjEEvPhT_iijj"]
    assert [i.opcode for i in first[:3]] == ["LDC", "IMAD", "LOP3"]
    assert [(i.address, i.target, i.conditional) for i in first if i.opcode == "BRA"] == [
        (0x30, 0x70, True), (0x60, 0x40, True), (0x90, 0x10, True), (0xb0, 0xa0, True)]
    outer, tail = dump_floor.loops(first)
    assert (outer["start"], outer["end"], outer["count"], outer["nested"]) == (0x10, 0x90, 9, 1)
    # 0x10, 0x20, 0x30 (taken), 0x70, 0x80 (the store), 0x90
    assert outer["group"] == {"count": 6, "alu": 2,
                              "opcodes": {"IMAD": 1, "LOP3": 1, "BRA": 2, "SHF": 1, "STG": 1}}
    assert (tail["start"], tail["end"], tail["count"], tail["group"]) == (0xa0, 0xb0, 2, None)


@pytest.mark.parametrize("T,instance,alu", [(801, "IjE", 2), (65537, "ImE", 3), (15, "IjE", 2)])
def test_dump_floor_takes_the_shapes_instance(T, instance, alu):
    """The 32-bit instance while B*H*T*T + 15 < 2^32, else the 64-bit one;
    its first loop with a 16-byte store; groups x ALU instructions over 64
    lanes a clock on each SM."""
    functions = dump_floor.parse_sass(SASS)
    floor, loop, name = dump_floor.dump_floor_ms(functions, 4, 4, T, 132, 1.98e9)
    assert instance in name and loop["group"]["alu"] == alu
    assert floor == pytest.approx(1e3 * -(-16 * T * T // 16) * alu / (132 * 64 * 1.98e9))


def test_dump_floor_needs_a_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        dump_floor.main(["4", "4", "801", "1", "1", "46341"])
    with pytest.raises(SystemExit):
        dump_floor.main(["4", "4"])  # shapes come as triples


def test_ab_attention_host_mode_needs_a_card(monkeypatch):
    """``--host`` times the wrappers on the card; its shape's kernels are
    small (one block a batch row and key tile)."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        ab_attention.main(["--host"])
    assert ab_attention.HOST_SHAPE["B"] * ab_attention.HOST_SHAPE["T"] <= 128


def test_ab_attention_dump_needs_a_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        ab_attention.main(["--dump"])
    assert ab_attention.DUMP_SHAPES[0] == (4, 4, max(ab_attention.SWEEP["T"]))
    B, H, T = ab_attention.DUMP_SHAPES[1]
    assert 2 ** 31 < B * H * T * T < 2 ** 32
