"""The counting functions against figures worked by hand from the shapes,
and the attribution of a trace's quantized matmuls to their least time."""

from __future__ import annotations

import pytest

from perfbench import counting, kernels
from perfbench.trace import parse

MISTRAL = counting.Model(hidden=4096, intermediate=14336, layers=32, heads=32,
                         kv_heads=8, head_dim=128, vocab=32000)
MIXTRAL = counting.Model(hidden=4096, intermediate=14336, layers=32, heads=32,
                         kv_heads=8, head_dim=128, vocab=32000, experts=8,
                         top_k=2)


def test_a_dense_decode_step_at_32_rows():
    # Per layer: wqkv 4096 x 6144, wo 4096 x 4096, wgu 4096 x 28672,
    # w_down 14336 x 4096; int8 bytes = K*O + 4*O.
    per_layer = (4096 * 6144 + 4 * 6144 + 4096 * 4096 + 4 * 4096
                 + 4096 * 28672 + 4 * 28672 + 14336 * 4096 + 4 * 4096)
    assert per_layer == 218_275_840
    got = sum(counting.weight_bytes(K, O, "int8") for K, O in
              ((4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096)))
    assert got == per_layer
    # x and out of a 32-row call: 2 bytes each, e.g. wqkv 32 * (4096 + 6144) * 2.
    flops, nbytes = counting.matmul(32, 4096, 6144,
                                    counting.weight_bytes(4096, 6144, "int8"))
    assert flops == 2 * 32 * 4096 * 6144
    assert nbytes == 4096 * 6144 + 4 * 6144 + 2 * 32 * (4096 + 6144)
    # Bytes bound it: 25.8 MB / 3.35 TB/s = 7.70 us against 0.51 us of math.
    assert counting.bound_s(flops, nbytes) == pytest.approx(
        nbytes / 3.35e12)


def test_a_256_row_chunk_is_bound_by_operations():
    flops, nbytes = counting.matmul(256, 4096, 28672,
                                    counting.weight_bytes(4096, 28672, "int8"))
    assert flops == 60_129_542_144
    # 60.13 GFLOP / 989 TFLOP/s = 60.80 us > 117.6 MB / 3.35 TB/s = 35.1 us.
    assert counting.bound_s(flops, nbytes) == pytest.approx(flops / 989e12)


def test_int4_bytes_count_half_a_byte_and_group_scales():
    assert counting.weight_bytes(14336, 4096, "int4", 256) == (
        14336 * 4096 // 2 + 4 * 56 * 4096)
    assert counting.weight_bytes(4096, 4096, "bf16") == 2 * 4096 * 4096


def test_an_moe_layer_under_the_16_row_rule():
    assert counting.expert_rows_read(32, 8, 2) == 8
    assert counting.expert_rows_read(16, 8, 2) == 8
    assert counting.expert_rows_read(1, 8, 2) == 2
    for rows in range(2, 16):
        assert counting.expert_rows_read(rows, 8, 2) is None
    # One Mixtral layer's active weights: attention, the router, two experts.
    assert MIXTRAL.layer_params() == (4096 * 6144 + 4096 * 4096 + 4096 * 8
                                      + 2 * 3 * 4096 * 14336)


def test_attention_over_a_window():
    # QK^T and PV: 2 * 2 * 128 flops a key, a head, a layer.
    assert MISTRAL.attention_flops(1000) == 4 * 32 * 32 * 128 * 1000
    tok = MISTRAL.decode_flops(1000)
    assert tok == 2 * 32 * 218_103_808 + 2 * 4096 * 32000 + 4 * 32 * 32 * 128 * 1000


def test_prefill_counts_causal_keys_after_the_cached_prefix():
    # 3 new tokens after 88 cached see 89, 90 and 91 keys.
    f = MISTRAL.prefill_flops(3, 88)
    assert f == (2 * 32 * 218_103_808 * 3 + MISTRAL.attention_flops(270)
                 + 2 * 4096 * 32000)


def _kernel(name, ts, dur, grid, corr):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"grid": grid, "correlation": corr}, "pid": 0, "tid": 7}


def _launch(ts, corr, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": ts, "dur": 1, "args": {"correlation": corr}, "pid": 1,
            "tid": tid}


def _range(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "pid": 1, "tid": tid}


def test_launches_are_told_apart_by_grid_and_order():
    """A tick's wqkv, wo, wgu, w_down (with a split-K reduce) and an
    admission's lm_head over R = 2 rows of S = 64."""
    evs = [_range("sched.tick", 0, 100), _range("sched.admit", 200, 100)]
    evs.append({"ph": "X", "cat": "cpu_op", "name": "aten::mean", "ts": 201,
                "dur": 1, "pid": 1, "tid": 1,
                "args": {"Input Dims": [[2, 64, 4096], [1]]}})
    grids = [48, 32, 224, 32]
    for i, g in enumerate(grids):
        evs += [_launch(10 + i, i), _kernel("qmm_kernel<16>", 1000 + 10 * i,
                                            8, [g, 2, 8], i)]
    evs += [_launch(15, 9), _kernel("qmm_reduce", 1040, 2, [32, 1, 1], 9)]
    evs += [_launch(210, 20), _kernel("qmm_kernel<16>", 2000, 50, [250, 1, 1],
                                      20)]
    tr = parse({"traceEvents": evs})
    dec = kernels.launches(tr, MISTRAL, ("tick",), 32)
    assert [x[0] for x in dec] == ["wqkv", "wo", "wgu", "w_down"]
    assert dec[3][2] == pytest.approx(10e-6)          # 8 us + its reduce
    wd = counting.weight_bytes(14336, 4096, "int8")
    assert dec[3][1] == pytest.approx(counting.bound_s(
        *counting.matmul(32, 14336, 4096, wd)))
    pre = kernels.launches(tr, MISTRAL, ("admit",), 32)
    assert [x[0] for x in pre] == ["lm_head"]
    assert pre[0][1] == pytest.approx(counting.bound_s(*counting.matmul(
        2, 4096, 32000, counting.weight_bytes(4096, 32000, "int8"))))
    share = kernels.roofline_pct(tr, MISTRAL, ("tick",), 32)
    assert share == pytest.approx(100 * sum(x[1] for x in dec)
                                  / sum(x[2] for x in dec))
    assert kernels.op_device_s(tr, ("tick",)) == pytest.approx(42e-6)


def test_expert_launches_count_every_expert_from_16_rows():
    evs = [_range("sched.tick", 0, 100)]
    for i, g in enumerate([48, 32, 224, 32]):
        evs += [_launch(10 + i, i), _kernel("qmm4_kernel<16>", 1000 + 10 * i,
                                            8, [g, 2, 8], i)]
    tr = parse({"traceEvents": evs})
    ls = kernels.launches(tr, MIXTRAL, ("tick",), 32)
    wb = counting.weight_bytes(4096, 28672, "int4", 128)
    assert ls[2][0] == "wgu"
    assert ls[2][1] == pytest.approx(counting.bound_s(
        *counting.matmul(64, 4096, 28672, 8 * wb)))
    assert kernels.launches(tr, MIXTRAL, ("tick",), 5)[2:] == []
