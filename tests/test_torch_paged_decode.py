"""The split-K paged decode kernel (``csrc/paged_attention.cu``).

On the CPU: the split plan (:func:`split_plan`), and a torch emulation of the
kernel's schedule — splits of the block table, runs of positions taken by
four warps in turn, each warp's online-softmax state updated once per run with
p rounded to the input type at the warp's running maximum, the warps' states
merged in warp order, then the splits' states in split order. It is held
against ``paged_decode_attention_plain`` and against the numpy reference of
the JAX package's tests (``tests/test_paged_attention.py``, copied below; the
JAX Pallas kernel cannot run on this tree), in f32 and bf16. Tolerances as in
``tests/test_torch_attention.py``: f32 1e-5 (both sides f32, other summation
orders); bf16 two bf16 ulps of the reference element plus 2^-8 (p is rounded
to bf16 at other running maxima on the two sides).

The ``cuda``-marked tests hold the kernel against the plain version on the
card and skip where there is none.
"""

import inspect
import math

import numpy as np
import pytest
import torch

from marlin_tpu_torch.ops import paged_attention as pa

F32_TOL = 1e-5
BF16_ATOL = 2.0 ** -8
WARPS = 4  # csrc/paged_attention.cu: kWarps


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def assert_bf16_close(got, want):
    """Every element of ``got`` within two bf16 ulps of the same element of
    ``want`` plus BF16_ATOL."""
    got, want = (np.asarray(t.float().cpu() if isinstance(t, torch.Tensor)
                            else t, np.float32) for t in (got, want))
    _, e = np.frexp(want)  # |want| = m * 2^e, m in [0.5, 1): ulp 2^(e - 8)
    tol = np.where(want != 0, np.ldexp(2.0, e - 8), 0.0) + BF16_ATOL
    bad = np.abs(got - want) > tol
    assert not bad.any(), (f"{int(bad.sum())} elements off, max |err| "
                           f"{float(np.abs(got - want).max())}")


def _ref_attention(q, k_pages, v_pages, tables, lengths):
    """Straight-line numpy decode attention: gather each row's context by
    block table, mask past its length, softmax, weigh V (copied from
    tests/test_paged_attention.py)."""
    q = np.asarray(q, np.float32)
    kp = np.asarray(k_pages, np.float32)
    vp = np.asarray(v_pages, np.float32)
    B, kvh, group, dh = q.shape
    W = tables.shape[1]
    page_len = kp.shape[1]
    out = np.zeros_like(q)
    for b in range(B):
        k = kp[tables[b]].reshape(W * page_len, kvh, dh)
        v = vp[tables[b]].reshape(W * page_len, kvh, dh)
        n = int(np.clip(lengths[b], 1, W * page_len))
        s = np.einsum("kgd,tkd->kgt", q[b], k[:n]) / np.sqrt(dh)
        s = s - s.max(axis=2, keepdims=True)
        p = np.exp(s)
        p = p / p.sum(axis=2, keepdims=True)
        out[b] = np.einsum("kgt,tkd->kgd", p, v[:n])
    return out


def _merge(states):
    """Online-softmax states (m, l, acc) merged in order, as the kernel
    merges its warps and the combine kernel its splits."""
    m = states[0][0]
    for st in states[1:]:
        m = torch.maximum(m, st[0])
    l = torch.zeros_like(m)
    acc = torch.zeros_like(states[0][2])
    for sm, sl, sa in states:
        f = torch.exp(sm - m)
        l = l + f * sl
        acc = acc + f[..., None] * sa
    return m, l, acc


def emulate_split_k(q, kp, vp, tables, lengths, plan: pa.PagedPlan):
    """The kernel's schedule in torch, f32 arithmetic, p rounded to q's
    dtype at each warp's running maximum."""
    B, kvh, group, dh = q.shape
    page_len = kp.shape[1]
    W = tables.shape[1]
    div = float(np.float32(math.sqrt(dh)))
    out = torch.empty(q.shape, dtype=q.dtype)
    for b in range(B):
        n_live = int(np.clip(int(lengths[b]), 1, W * page_len))
        k = kp[tables[b].long()].reshape(W * page_len, kvh, dh).float()
        v = vp[tables[b].long()].reshape(W * page_len, kvh, dh).float()
        qf = q[b].float()
        splits = []
        for s in range(plan.splits):
            p_begin = s * plan.split_pages * page_len
            p_end = min(min(W, (s + 1) * plan.split_pages) * page_len, n_live)
            runs = -(-(p_end - p_begin) // plan.rows) if p_end > p_begin else 0
            warps = []
            for w in range(WARPS):
                m = torch.full((kvh, group), -1e30)
                l = torch.zeros((kvh, group))
                acc = torch.zeros((kvh, group, dh))
                for r in range(w, runs, WARPS):
                    p0 = p_begin + r * plan.rows
                    p1 = min(p0 + plan.rows, p_end)
                    sc = torch.einsum("kgd,tkd->kgt", qf, k[p0:p1]) / div
                    m_new = torch.maximum(m, sc.amax(dim=-1))
                    alpha = torch.exp(m - m_new)
                    p = torch.exp(sc - m_new[..., None])
                    l = alpha * l + p.sum(dim=-1)
                    pv = torch.einsum("kgt,tkd->kgd",
                                      p.to(q.dtype).float(), v[p0:p1])
                    acc = acc * alpha[..., None] + pv
                    m = m_new
                warps.append((m, l, acc))
            splits.append(_merge(warps))
        _, l, acc = _merge(splits)
        out[b] = (acc / l[..., None]).to(q.dtype)
    return out


def _case(rng, B, kvh, group, dh, page_len, W, lengths, dummy_rows=()):
    n_pages = B * W + 1
    q = rng.standard_normal((B, kvh, group, dh)).astype(np.float32)
    kp, vp = (rng.standard_normal((n_pages, page_len, kvh, dh))
              .astype(np.float32) for _ in range(2))
    tables = (1 + rng.permutation(n_pages - 1)[:B * W]).reshape(B, W)
    tables[list(dummy_rows)] = 0
    return (q, kp, vp, tables.astype(np.int32),
            np.asarray(lengths, np.int32))


# ------------------------------------------------------------ the plan


@pytest.mark.parametrize("B,kvh,group,dh,W,itemsize,sms", [
    (8, 8, 1, 64, 36, 4, 132),      # the serving bucket
    (1, 8, 1, 64, 1024, 4, 132),    # 16384 tokens
    (8, 2, 4, 64, 36, 2, 132),      # GQA, bf16
    (4, 2, 16, 256, 36, 4, 132),    # two chunks of 8 heads
    (5, 2, 4, 40, 7, 4, 132),
    (3, 1, 1, 8, 5000, 4, 132),     # more pages than a split holds
    (1, 1, 1, 64, 1, 4, 132),
])
def test_split_plan_covers_the_table_once(B, kvh, group, dh, W, itemsize,
                                          sms):
    plan = pa.split_plan(B, kvh, group, dh, W, itemsize, sms)
    cover = [w for s in range(plan.splits)
             for w in range(s * plan.split_pages,
                            min(W, (s + 1) * plan.split_pages))]
    assert cover == list(range(W))
    # no split past the table: the last one starts inside it
    assert (plan.splits - 1) * plan.split_pages < W
    assert plan.split_pages <= pa.MAX_SPLIT_PAGES
    assert 1 <= plan.rows <= pa.MAX_ROWS
    chunks = pa.group_chunks(group, dh)
    assert plan.chunks == len(chunks)
    assert plan.chunk_heads == max(sl.stop - sl.start for sl in chunks)
    assert plan.chunk_heads * pa.lane_dh(dh) <= pa.KERNEL_GROUP_DH


def test_split_plan_fills_the_card_and_stops_there():
    # the serving bucket: 64 (row, kv head) blocks on 132 SMs -> 9 splits
    plan = pa.split_plan(8, 8, 1, 64, 36, 4, 132)
    assert (plan.splits, plan.split_pages, plan.rows) == (9, 4, 4)
    # 16384 tokens at batch 1: 8 blocks -> 64 splits of 16 pages
    plan = pa.split_plan(1, 8, 1, 64, 1024, 4, 132)
    assert (plan.splits, plan.split_pages) == (64, 16)
    # B * kvh alone fills the card: one split, no combine
    assert pa.split_plan(64, 8, 1, 64, 36, 4, 132).splits == 1
    assert pa.split_plan(33, 8, 1, 64, 36, 4, 132).splits == 1
    # more pages than a split may hold: split all the same
    assert pa.split_plan(64, 8, 1, 64, 4096, 4, 132).splits == 4


def test_split_plan_reads_no_lengths():
    """The plan is a function of shapes: the wrapper never waits on the card
    for the lengths."""
    params = set(inspect.signature(pa.split_plan).parameters)
    assert "lengths" not in params and "tables" not in params


@pytest.mark.parametrize("dh,want", [(1, 32), (32, 32), (40, 64), (64, 64),
                                     (96, 128), (256, 256), (1000, 1024),
                                     (2048, 2048)])
def test_lane_dh(dh, want):
    assert pa.lane_dh(dh) == want


@pytest.mark.parametrize("group,dh,want", [
    (21, 96, [16, 5]),    # 96 takes 128 values of a lane's row: 16, not 21
    (10, 200, [8, 2]),    # 200 takes 256: 8 heads, not 10
    (40, 32, [16, 16, 8]),  # 64 heads would fit the lanes; m, l cap it at 16
])
def test_group_chunks_follow_the_lane_layout(group, dh, want):
    assert [sl.stop - sl.start for sl in pa.group_chunks(group, dh)] == want


# --------------------------------------------------- the schedule, emulated


CASES = {
    # ragged lengths: 1, a page edge, mid-table, the full table
    "ragged": dict(B=4, kvh=2, group=2, dh=8, page_len=8, W=8,
                   lengths=[1, 8, 37, 64], sms=8),
    # a length that ends inside the first split; the other splits are empty
    "first_split_only": dict(B=3, kvh=2, group=1, dh=16, page_len=4, W=12,
                             lengths=[3, 5, 2], sms=4),
    # whole empty splits beside full ones, and a dummy (all-zero table) row
    "empty_splits_dummy": dict(B=3, kvh=1, group=4, dh=32, page_len=4, W=16,
                               lengths=[64, 9, 30], dummy_rows=(1,), sms=8),
    # page_len 5 and dh 40, the kernel's element-wise copies in bf16
    "page5_dh40": dict(B=5, kvh=2, group=4, dh=40, page_len=5, W=7,
                       lengths=[35, 1, 17, 6, 20], sms=16),
    # one split: the split kernel writes the output itself
    "one_split": dict(B=4, kvh=2, group=2, dh=8, page_len=8, W=8,
                      lengths=[1, 8, 37, 64], sms=1),
}


def _run_case(name, dtype, plan=None):
    c = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    q, kp, vp, tables, lengths = _case(
        rng, c["B"], c["kvh"], c["group"], c["dh"], c["page_len"], c["W"],
        c["lengths"], c.get("dummy_rows", ()))
    t = [torch.from_numpy(a).to(dtype) for a in (q, kp, vp)]
    tb, ln = torch.from_numpy(tables), torch.from_numpy(lengths)
    if plan is None:
        plan = pa.split_plan(c["B"], c["kvh"], c["group"], c["dh"], c["W"],
                             t[0].element_size(), c["sms"])
    got = emulate_split_k(*t, tb, ln, plan)
    plain = pa.paged_decode_attention_plain(*t, tb, ln)
    ref = _ref_attention(*(a.float().numpy() for a in t), tables, lengths)
    return got, plain, ref, plan


@pytest.mark.parametrize("name", sorted(CASES))
def test_emulated_split_k_matches_plain_and_reference_f32(name):
    got, plain, ref, plan = _run_case(name, torch.float32)
    assert (plan.splits == 1) == (name == "one_split")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(got.numpy(), ref, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_emulated_split_k_matches_plain_and_reference_bf16(name):
    got, plain, ref, _ = _run_case(name, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert_bf16_close(got, plain)
    assert_bf16_close(got, ref)


@pytest.mark.parametrize("rows", [1, 2, 3])
def test_emulated_runs_spread_over_warps(rows):
    """Short runs give each warp several runs and every warp a state to
    merge; the result does not depend on how the split is cut."""
    plan = pa.PagedPlan(splits=3, split_pages=3, rows=rows, chunk_heads=2,
                        chunks=1)
    got, plain, ref, _ = _run_case("ragged", torch.float32, plan)
    np.testing.assert_allclose(got.numpy(), ref, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=F32_TOL,
                               atol=F32_TOL)


# ------------------------------------------------------------- on the card


CARD_CASES = [  # (B, kvh, group, dh, page_len, W)
    (8, 8, 1, 64, 16, 36),     # the serving bucket
    (1, 8, 1, 64, 16, 1024),   # 16384 tokens
    (8, 2, 4, 64, 16, 36),     # GQA group 4
    (4, 2, 16, 256, 16, 36),   # two chunks of 8 heads of 256
    (5, 2, 4, 40, 5, 7),       # page_len 5, dh 40
]


def _card_case(dev, dtype, B, kvh, group, dh, page_len, W, seed):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    n_pages = B * W + 1
    q = torch.randn((B, kvh, group, dh), generator=gen, device=dev).to(dtype)
    kp = torch.randn((n_pages, page_len, kvh, dh), generator=gen,
                     device=dev).to(dtype)
    vp = torch.randn((n_pages, page_len, kvh, dh), generator=gen,
                     device=dev).to(dtype)
    tables = (1 + torch.randperm(n_pages - 1, generator=gen, device=dev)
              [:B * W]).reshape(B, W).int()
    lengths = torch.randint(1, W * page_len + 1, (B,), generator=gen,
                            device=dev).int()
    lengths[0] = W * page_len
    if B > 2:
        tables[1] = 0
        lengths[2] = 1
    return q, kp, vp, tables, lengths


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", CARD_CASES)
def test_cuda_split_kernel_matches_plain(cuda, dtype, shape):
    args = _card_case(cuda, dtype, *shape, seed=sum(shape))
    got = pa.paged_decode_attention(*args)
    want = pa.paged_decode_attention_plain(*args)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == args[0].shape
    assert bool(torch.isfinite(got.float()).all())
    if dtype == torch.float32:
        assert float((got - want).abs().max()) <= F32_TOL
    else:
        assert_bf16_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_split_kernel_runs_are_bit_identical(cuda, dtype):
    for shape in CARD_CASES[:2]:
        args = _card_case(cuda, dtype, *shape, seed=7)
        a = pa.paged_decode_attention(*args)
        b = pa.paged_decode_attention(*args)
        assert torch.equal(a, b)
