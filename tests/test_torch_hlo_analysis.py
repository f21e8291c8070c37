"""The port's roofline accounting (``launch/hlo_analysis.py``).

* ``roofline_terms``: the reference's formula at an H100's constants (the
  counterpart of ``tests/test_roofline_analysis.py::test_roofline_terms_math``),
  and the reference's own function on the same inputs at its constants
  rescaled, term for term.
* ``analyze_callable``: FLOPs of a loop of L matmuls equal L·2·D³ exactly
  (the counterpart of ``test_real_compiled_module_roundtrip``), and equal
  ``FlopCounterMode``'s on the same run; the bytes of a hand-counted op
  sequence, views, allocation, same-dtype casts and host-side ops counted
  as zero; a backward run inside is counted.
"""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.launch import hlo_analysis as jha
from repro_torch.launch import hlo_analysis as ha


def test_h100_constants():
    assert (ha.PEAK_FLOPS, ha.HBM_BW, ha.LINK_BW) == (989e12, 3.35e12, 450e9)


def test_roofline_terms_math():
    r = ha.roofline_terms(
        hlo_flops=ha.PEAK_FLOPS,  # exactly 1 s of compute
        hlo_bytes=ha.HBM_BW / 2,  # 0.5 s of memory
        collective_bytes=ha.LINK_BW / 4,  # 0.25 s on the link
        chips=4,
        model_flops=2 * ha.PEAK_FLOPS,  # 0.5 s useful per chip
    )
    assert r["dominant"] == "compute"
    assert r["bound_s"] == pytest.approx(1.0)
    assert r["memory_s"] == pytest.approx(0.5)
    assert r["collective_s"] == pytest.approx(0.25)
    assert r["roofline_fraction"] == pytest.approx(0.5)
    assert r["useful_flops_ratio"] == pytest.approx(0.5)
    link = ha.roofline_terms(hlo_flops=0.0, hlo_bytes=0.0, collective_bytes=ha.LINK_BW,
                             chips=1, model_flops=0.0)
    assert link["dominant"] == "collective" and link["bound_s"] == pytest.approx(1.0)


@pytest.mark.parametrize("flops, n_bytes, coll", [(3e15, 2e12, 1e9), (1e12, 8e12, 0.0),
                                                  (0.0, 1e9, 9e11)])
def test_roofline_terms_is_the_references_formula(flops, n_bytes, coll):
    """The reference's function at its TPU constants, fed inputs scaled by
    the ratio of the constants, gives the port's terms."""
    got = ha.roofline_terms(hlo_flops=flops, hlo_bytes=n_bytes, collective_bytes=coll,
                            chips=8, model_flops=4e15)
    want = jha.roofline_terms(
        hlo_flops=flops * jha.PEAK_FLOPS / ha.PEAK_FLOPS,
        hlo_bytes=n_bytes * jha.HBM_BW / ha.HBM_BW,
        collective_bytes=coll * jha.ICI_BW / ha.LINK_BW,
        chips=8, model_flops=4e15 * jha.PEAK_FLOPS / ha.PEAK_FLOPS)
    for key in ("compute_s", "memory_s", "collective_s", "bound_s", "roofline_fraction"):
        assert got[key] == pytest.approx(want[key], rel=1e-12), key
    assert got["dominant"] == want["dominant"]


def test_loop_of_matmuls_flops_exact():
    L, D = 5, 32
    x = torch.empty((D, D), device="meta")
    w = torch.empty((D, D), device="meta")

    def f(c, w):
        for _ in range(L):
            c = c @ w
        return c

    stats, out = ha.analyze_callable(f, x, w)
    assert stats.flops == L * 2 * D * D * D
    assert out.shape == (D, D) and out.device.type == "meta"
    with FlopCounterMode(display=False) as fc:
        f(torch.randn(D, D), torch.randn(D, D))
    assert stats.flops == fc.get_total_flops()


def test_bytes_of_a_hand_counted_sequence():
    a = torch.empty((64, 32), dtype=torch.float32, device="meta")
    b = torch.empty((32, 16), dtype=torch.bfloat16, device="meta")
    host = torch.arange(8, dtype=torch.float32)

    def f(a, b):
        t = a.t()  # view: 0
        s = t[:, :8]  # view: 0
        s = s.reshape(8, 32).contiguous()  # a copy: 8*32*4 in and out
        c = a.to(torch.bfloat16)  # a cast: 64*32*(4 + 2)
        same = c.to(torch.bfloat16, copy=True)  # same dtype: an alias here, 0
        d = same @ b  # 64*32*2 + 32*16*2 in, 64*16*2 out
        e = torch.empty((64, 16), dtype=torch.bfloat16, device="meta")  # allocation: 0
        e.copy_(d)  # e and d in, e out: 3 * 64*16*2
        host.mul(2.0)  # host only: 0
        h = host.to("meta")  # from the host: 0
        return e, s, h

    stats, _ = ha.analyze_callable(f, a, b)
    want = (2 * 8 * 32 * 4
            + 64 * 32 * (4 + 2)
            + 64 * 32 * 2 + 32 * 16 * 2 + 64 * 16 * 2
            + 3 * 64 * 16 * 2)
    assert stats.bytes_accessed == want
    assert stats.bytes_raw == stats.bytes_accessed
    assert stats.flops == 2 * 64 * 32 * 16


def test_backward_inside_is_counted():
    D = 16
    w = torch.empty((D, D), device="meta", requires_grad=True)
    x = torch.empty((4, D), device="meta")

    def step(w, x):
        (x @ w).sum().backward()

    stats, _ = ha.analyze_callable(step, w, x)
    # forward 4 x D x D, backward dW = x^T @ grad (D x 4 x D); no dx (x needs none)
    assert stats.flops == 2 * (2 * 4 * D * D)


def test_stats_record():
    s = ha.HloStats(flops=1.0, bytes_accessed=2.0, bytes_raw=2.0)
    s.add_collective("all-gather", 10)
    s.add_collective("all-gather", 6)
    s.add_collective("reduce-scatter", 4, count=3)
    assert s.to_dict() == {"flops": 1.0, "bytes_accessed": 2.0, "bytes_raw": 2.0,
                           "collective_bytes": 20, "bytes_by_kind": {"all-gather": 16,
                                                                     "reduce-scatter": 4},
                           "count_by_kind": {"all-gather": 2, "reduce-scatter": 3}}
    assert set(s.to_dict()) == set(jha.HloStats().to_dict())
