"""Kernel 8's four modes in the PyTorch port (`int4_matmul(mode=...)`:
'unroll', 'dots', 'block', 'dots8') through their plain versions on the
CPU, held against the JAX package's `int4_matmul` with its Pallas kernel
in interpret mode, at the four shapes of tests/test_int4.py:76-81 and its
2e-4 ('dots8' quantizes x with IEEE divisions, as that test's oracle
does, where XLA's compiled division on the CPU is within two ulps and can
round a near-tie code the other way: such rows are held on the JAX
kernel's codes); the port's
'dots8' plain version in its kernel's order against the
same function summed group by group (1e-6 of the larger of the value and
its row's rms) and, above one row, bit-equal to the int8 wgmma design's
order written out block by block; that design's stream-K plan at the
edges of its instances on several SM counts, with and without split
tiles; what the 'dots8' wrapper hands its entry point; the nibble
identities its kernels rely on, on every byte value; an unknown mode
raising; 'block' and 'dots8' refusing a tensor that requires grad. The
kernels themselves are held against these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 2).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evo_tpu.ops import pallas_int4
from evo_tpu_torch.ops import _build, int4

torch.set_num_threads(2)

SHAPES = [(8, 256, 512), (1, 4096, 688), (16, 1536, 512), (128, 512, 1024),
          # 'dots8''s wgmma plan splits each tile between four blocks
          (40, 1024, 600)]


def _case(M, Kp, N):
    """x (M, Kp) bf16, the packed codes and the scales, as tests/test_int4
    draws them (from numpy here), in both packages."""
    rng = np.random.default_rng(M + N)
    x = torch.from_numpy(rng.standard_normal((M, Kp)).astype(np.float32)
                         ).bfloat16()
    q = torch.from_numpy(rng.integers(-8, 8, (Kp, N)).astype(np.int8))
    s = torch.from_numpy(rng.uniform(0.01, 0.1, (Kp // 128, N)).astype(
        np.float32))
    packed = int4.pack_int4(q)
    jargs = (jnp.asarray(x.float().numpy(), jnp.bfloat16),
             jnp.asarray(packed.numpy()), jnp.asarray(s.numpy()))
    return (x, packed, s), jargs


@functools.lru_cache(maxsize=None)
def _jax_kernel(M, Kp, N, mode):
    _, jargs = _case(M, Kp, N)
    return np.asarray(pallas_int4.int4_matmul(*jargs, interpret=True,
                                              mode=mode))


@jax.jit
def _jax_codes(x):
    """The 'dots8' branch's row quantization (`pallas_int4.py:121-124`) as
    XLA compiles it on the CPU, where the interpret-mode kernel runs it."""
    x32 = x.astype(jnp.float32)
    xs = jnp.maximum(jnp.max(jnp.abs(x32), axis=1, keepdims=True) / 127.0,
                     jnp.float32(1e-12))
    return jnp.clip(jnp.round(x32 / xs), -127, 127), xs


def _check_dots8_codes(x, jx):
    """The port's scale and codes come from IEEE divisions (as
    tests/test_int4.py's `_oracle_dots8` takes them); XLA's compiled
    division on the CPU is within two ulps of it, which can move a scale by
    an ulp and land a ratio next to a half-integer on the other side.
    Returns the JAX codes and scales, and a mask of the rows where the two
    quantizations give the same codes, after checking that every
    difference is such a tie, by one code."""
    codes, xs = int4.quantize_rows(x)
    jcodes, jxs = (np.asarray(a) for a in _jax_codes(jx))
    np.testing.assert_allclose(xs.numpy(), jxs, rtol=2.4e-7, atol=0)
    diff = codes.numpy() != jcodes
    ratio = np.abs(x.float().numpy() / xs.numpy())
    assert (np.abs(ratio[diff] % 1 - 0.5) < 1e-4).all()
    assert (np.abs(codes.numpy() - jcodes)[diff] == 1).all()
    assert diff.mean() < 1e-3
    return jcodes, jxs, ~diff.any(axis=1)


@pytest.mark.parametrize('M,Kp,N', SHAPES)
@pytest.mark.parametrize('mode', int4.MODES)
def test_plain_matches_jax_kernel(M, Kp, N, mode):
    """Each mode's plain version against the JAX kernel's same mode in
    interpret mode, at tests/test_int4.py's 2e-4; `int4_matmul` on a CPU
    tensor is that plain version, and its bf16 output the float32 one
    rounded once. 'dots8': every row whose codes the two quantizations
    give alike, and every row through the port's products on the JAX
    kernel's codes (`_check_dots8_codes`)."""
    targs, jargs = _case(M, Kp, N)
    got = int4.int4_matmul(*targs, mode=mode)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    want = _jax_kernel(M, Kp, N, mode)
    if mode == 'dots8':
        jcodes, jxs, same = _check_dots8_codes(targs[0], jargs[0])
        np.testing.assert_allclose(got.numpy()[same], want[same], rtol=2e-4,
                                   atol=2e-4)
        got = int4.dots8_products(torch.from_numpy(jcodes),
                                  torch.from_numpy(jxs), *targs[1:])
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    got = int4.int4_matmul(*targs, mode=mode)
    plain = {'unroll': int4.int4_matmul_plain, 'dots': int4.int4_matmul_plain,
             'block': int4.int4_matmul_block_plain,
             'dots8': int4.int4_matmul_dots8_plain}[mode]
    assert torch.equal(got, plain(*targs))
    assert torch.equal(int4.int4_matmul(*targs, torch.bfloat16, mode=mode),
                       got.bfloat16())


@pytest.mark.parametrize('M,K,Kp,N', [(3, 130, 256, 40), (9, 4000, 4096, 700),
                                      (1, 10928, 11008, 64)])
def test_plain_modes_read_x_of_k_columns(M, K, Kp, N):
    """x of K <= Kp columns reads as zeros past K in every mode, as the
    kernels take it: equal to the call on x padded to Kp."""
    targs, _ = _case(M, Kp, N)
    x, packed, s = targs
    for mode in int4.MODES:
        got = int4.int4_matmul(x[:, :K].contiguous(), packed, s, mode=mode)
        want = int4.int4_matmul(
            torch.nn.functional.pad(x[:, :K], (0, Kp - K)), packed, s,
            mode=mode)
        assert torch.equal(got, want), mode


@pytest.mark.parametrize('M,Kp,N,sms', [
    (1, 4096, 12288, 132), (2, 256, 40, 132),       # the streaming design
    (9, 4096, 1024, 132), (128, 11008, 512, 132), (9, 4096, 3000, 132),
    (3, 4096, 3000, 114), (65, 2048, 600, 78), (33, 1536, 1001, 7)])
def test_dots8_order_against_group_sums(M, Kp, N, sms, monkeypatch):
    """The kernel's order of float32 sums (above DOTS8_STREAM_MAX rows the
    wgmma design's: a block's steps of a tile in order, the tile's parts in
    block order, `mma_plan` on `sms` SMs; else the streaming design's
    splits, `dots8_stream_plan`) against the same integer dots summed group
    by group: one function, within 1e-6 of the larger of the value and its
    row's rms; and the row codes are the JAX kernel's quantization."""
    monkeypatch.setattr(int4, 'SMS', sms)
    targs, _ = _case(M, Kp, N)
    x, packed, s = targs
    if M <= int4.DOTS8_STREAM_MAX:
        splits, steps = int4.dots8_stream_plan(Kp, N)
        assert splits * steps >= Kp // 256 > (splits - 1) * steps
    got = int4.int4_matmul_dots8_plain(*targs)
    codes, xs = int4.quantize_rows(x)
    G = Kp // 128
    w = int4.unpack_int4(packed).double().reshape(G, 128, N)
    want = sum((codes.double().reshape(M, G, 128)[:, g] @ w[g])
               * s[g].double() for g in range(G)) * xs.double()
    rms = want.pow(2).mean(-1, keepdim=True).sqrt()
    assert float(((got.double() - want).abs()
                  / want.abs().maximum(rms)).max()) <= 1e-6
    # the codes of tests/test_int4.py's `_oracle_dots8`, bit for bit
    x32 = x.float().numpy()
    xs_j = np.maximum(np.abs(x32).max(1, keepdims=True) / np.float32(127),
                      np.float32(1e-12))
    np.testing.assert_array_equal(xs.numpy(), xs_j)
    np.testing.assert_array_equal(
        codes.numpy(), np.clip(np.round(x32 / xs_j), -127, 127))


def _kernel_sums(codes, xs, packed, scales, sms):
    """'dots8''s wgmma design written out block by block as the kernel
    runs it: block b of G takes units [b U / G, (b + 1) U / G) of the (tile,
    step) units; a step's integer dots (int64 here, no float32 at all)
    give p = (lo * s_t) + (hi * s_T+t), a block's steps of a tile add in
    order, the tile's parts in block order, then times xs."""
    M, _ = codes.shape
    Kp = 2 * packed.shape[0]
    N = packed.shape[1]
    T = Kp // 256
    c = torch.nn.functional.pad(codes, (0, Kp - codes.shape[1])).long()
    q = int4.unpack_int4(packed).long()
    _n, cols, G, _parts = int4.mma_plan(M, Kp, N, sms)
    tiles = -(-N // cols)
    U = tiles * T
    y = torch.empty((M, N), dtype=torch.float32)
    for tile in range(tiles):
        n0, n1 = tile * cols, min(N, tile * cols + cols)
        parts = []
        for b in range(G):
            u0 = max(b * U // G, tile * T)
            u1 = min((b + 1) * U // G, tile * T + T)
            run = None
            for u in range(u0, u1):
                t = u - tile * T
                lo = c[:, 128 * t:128 * t + 128] @ q[128 * t:128 * t + 128,
                                                    n0:n1]
                hi = c[:, Kp // 2 + 128 * t:Kp // 2 + 128 * t + 128] @ \
                    q[Kp // 2 + 128 * t:Kp // 2 + 128 * t + 128, n0:n1]
                p = lo.float() * scales[t, n0:n1] + \
                    hi.float() * scales[T + t, n0:n1]
                run = p if run is None else run + p
            if run is not None:
                parts.append(run)
        total = parts[0]
        for part in parts[1:]:
            total = total + part
        y[:, n0:n1] = total * xs
    return y


@pytest.mark.parametrize('M,Kp,N,sms', [
    (3, 512, 300, 132), (9, 4096, 1024, 7), (17, 1536, 700, 11),
    (40, 2048, 600, 5), (65, 1024, 260, 3), (128, 512, 1024, 3),
    (16, 2560, 520, 78)])
def test_dots8_plain_adds_in_the_kernels_order(M, Kp, N, sms, monkeypatch):
    """The plain version above DOTS8_STREAM_MAX rows (its order vectorized
    over the columns, `dots8_segments`) bit-equal to the kernel's order
    written out block by block, on plans whose blocks take one unit or
    runs of steps across tiles (few SMs), from x of K < Kp columns."""
    monkeypatch.setattr(int4, 'SMS', sms)
    assert M > int4.DOTS8_STREAM_MAX
    targs, _ = _case(M, Kp, N)
    x = targs[0][:, :Kp - 5].contiguous()
    codes, xs = int4.quantize_rows(x)
    want = _kernel_sums(codes, xs, *targs[1:], sms)
    assert torch.equal(int4.int4_matmul_dots8_plain(x, *targs[1:]), want)
    assert torch.equal(int4.dots8_products(codes, xs, *targs[1:]), want)


# the rows at each side of the wgmma design's instances (n = 16 .. 128)
BOUNDARY_ROWS = (3, 4, 16, 17, 32, 33, 64, 65, 128)


@pytest.mark.parametrize('sms', [132, 114, 78])
@pytest.mark.parametrize('M', BOUNDARY_ROWS)
def test_dots8_plan_at_every_instance_boundary(M, sms):
    """'dots8' above DOTS8_STREAM_MAX rows takes `mma_plan`: x's rows padded
    to the smallest instance n that holds them, 256 columns a block at n
    <= 32 (128 above), min(U, sms) persistent blocks over the U = tiles x T
    units in equal runs, each unit to one block, each tile's steps to
    consecutive blocks in order, at most `parts` of them (0 when every
    block takes whole tiles: a shape without split tiles and one with);
    `dots8_segments` starts and ends a segment where the block changes."""
    assert M > int4.DOTS8_STREAM_MAX
    n = min(c for c in (16, 32, 64, 128) if c >= M)
    cols = 256 if n <= 32 else 128
    whole_N = sms * cols                 # a tile a block: T = 2 units
    for Kp, N, split in ((512, whole_N, False), (4096, 12288, True),
                         (1024, 1001, True)):
        got = int4.mma_plan(M, Kp, N, sms)
        T, tiles = Kp // 256, -(-N // cols)
        U = tiles * T
        assert got[:3] == (n, cols, min(U, sms))
        blocks, parts = got[2], got[3]
        assert (parts > 0) == split
        owner = [int4._unit_block(u, U, blocks) for u in range(U)]
        assert [sum(1 for o in owner if o == b) for b in range(blocks)] == \
            [(b + 1) * U // blocks - b * U // blocks for b in range(blocks)]
        start, end = int4.dots8_segments(M, Kp, N, sms)
        assert start.shape == end.shape == (N, T)
        for tile in range(tiles):
            steps = owner[tile * T:(tile + 1) * T]
            assert steps == sorted(steps)
            assert len(set(steps)) <= max(parts, 1)
            col = tile * cols
            assert start[col].tolist() == [t == 0 or steps[t] != steps[t - 1]
                                           for t in range(T)]
            assert end[col].tolist() == [t == T - 1 or steps[t] != steps[t + 1]
                                         for t in range(T)]


@pytest.mark.parametrize('M,K,Kp,N', [
    (1, 4096, 4096, 12288), (2, 4093, 4096, 600), (3, 4096, 4096, 12288),
    (9, 10928, 11008, 4096), (64, 130, 512, 136), (128, 4096, 4096, 10928)])
def test_dots8_wrapper_launches_the_plan(monkeypatch, M, K, Kp, N):
    """What the 'dots8' wrapper hands its entry point, recorded in place of
    the launch: the streaming plan up to DOTS8_STREAM_MAX rows (blocks 0),
    else `mma_plan`'s blocks (steps 0); the codes and row
    scales in the device's kept buffer, 16-byte aligned; the workspace and
    the tickets exactly when a tile is split; x as given, any K."""
    calls = []
    monkeypatch.setattr(int4._build, 'launch',
                        lambda name, counter, *args: calls.append(
                            (name, counter, args)))
    monkeypatch.setattr(int4._build, 'sm_count', lambda index: int4.SMS)
    g = torch.Generator().manual_seed(M)
    x = torch.randn(M, K, generator=g).bfloat16()
    packed = torch.randint(-128, 128, (Kp // 2, N), generator=g,
                           dtype=torch.int8)
    s = torch.rand(Kp // 128, N, generator=g)
    int4.int4_dots8_kernel(x, packed, s, torch.bfloat16)
    (name, counter, (xp, _p, _s, _y, xq, xs, part, tickets, m, k, kp, n,
                     steps, blocks, bf16)), = calls
    assert (name, counter) == ('evo_int4_dots8_bf16', 'int4_matmul_dots8')
    assert (xp, m, k, kp, n, bf16) == (x.data_ptr(), M, K, Kp, N, 1)
    kept = int4._CODES[x.device][-1]
    assert xq == kept.data_ptr() and xq % 16 == 0
    assert xs == xq + M * Kp and kept.numel() >= M * Kp + 4 * M
    if M <= int4.DOTS8_STREAM_MAX:
        splits, want_steps = int4.dots8_stream_plan(Kp, N)
        assert (steps, blocks) == (want_steps, 0)
        parts = splits if splits > 1 else 0
    else:
        _n, _cols, want_blocks, parts = int4.mma_plan(M, Kp, N)
        assert (steps, blocks) == (0, want_blocks)
    assert (part is not None) == (parts > 0) == (tickets is not None)
    if parts:
        assert part == int4._WORKSPACE[x.device][-1].data_ptr()


def test_nibble_identities_are_exact():
    """The kernel's nibbles as signed bytes of 16 q, on every byte value in
    every byte of a word: the high nibble as (w & 0xf0f0f0f0), the low one
    (stored as q + 8) as ((w << 4) & 0xf0f0f0f0) ^ 0x80808080, against
    `unpack_int4`; their products with every code in [-127, 127] are
    multiples of 16, and 128 of them summed in int32 (the kernel's s32
    accumulator, here at the largest magnitude and at random) shifted
    right by 4 are the dot of the codes with q, exactly. The streaming
    design's (w & 0x0f0f0f0f) is q + 8, so its sum less 8 times the codes'
    sum is the same dot."""
    b = np.arange(256, dtype=np.uint32)
    q = int4.unpack_int4(torch.from_numpy(b.astype(np.uint8).view(np.int8)
                                          ).reshape(256, 1)).numpy()
    q_lo, q_hi = q[:256, 0].astype(np.int64), q[256:, 0].astype(np.int64)

    def signed_bytes(w, e):
        return ((w >> np.uint32(8 * e)) & np.uint32(255)).astype(
            np.uint8).view(np.int8).astype(np.int64)
    rng = np.random.default_rng(0)
    for e in range(4):
        other = rng.integers(0, 2 ** 32, 256, dtype=np.uint64).astype(
            np.uint32) & ~np.uint32(255 << (8 * e))
        w = other | (b << np.uint32(8 * e))
        low = ((w << np.uint32(4)) & np.uint32(0xf0f0f0f0)) ^ \
            np.uint32(0x80808080)
        high = w & np.uint32(0xf0f0f0f0)
        np.testing.assert_array_equal(signed_bytes(low, e), 16 * q_lo)
        np.testing.assert_array_equal(signed_bytes(high, e), 16 * q_hi)
        np.testing.assert_array_equal(
            signed_bytes(w & np.uint32(0x0f0f0f0f), e), q_lo + 8)
    codes = np.arange(-127, 128, dtype=np.int64)
    for qv in (q_lo, q_hi):
        prod = codes[:, None] * (16 * qv)[None, :]
        assert (prod % 16 == 0).all()
        np.testing.assert_array_equal(prod >> 4, codes[:, None] * qv)
        # 128 of the largest products: within int32
        assert (128 * np.abs(prod)).max() < 2 ** 31
        x = rng.integers(-127, 128, (64, 128)).astype(np.int32)
        k = rng.integers(0, 256, (128, 64))
        acc = x @ (16 * qv[k]).astype(np.int32)         # int32 sums
        assert acc.dtype == np.int32
        np.testing.assert_array_equal(acc >> 4, x.astype(np.int64) @ qv[k])
        worst = np.full(128, -127, np.int32) @ np.full(128, -128, np.int32)
        assert worst == 127 * 128 * 128


def test_unknown_mode_raises():
    targs, _ = _case(8, 256, 512)
    with pytest.raises(ValueError, match='unknown int4_matmul mode'):
        int4.int4_matmul(*targs, mode='unpack')


@pytest.mark.parametrize('mode', ['block', 'dots8'])
def test_block_and_dots8_refuse_grad(mode, monkeypatch):
    """No model path reaches these modes under grad, and they have no
    backward: a tensor that requires grad raises, on the CPU and before a
    launch on the card; under no_grad the same call runs."""
    targs, _ = _case(8, 256, 512)
    x = targs[0].float().requires_grad_()
    with pytest.raises(RuntimeError, match='no backward'):
        int4.int4_matmul(x, *targs[1:], mode=mode)
    monkeypatch.setattr(_build, 'check_device', lambda t, what: True)
    monkeypatch.setattr(_build, 'launch', lambda *a: pytest.fail('launched'))
    with pytest.raises(RuntimeError, match='no backward'):
        int4.int4_matmul(x, *targs[1:], mode=mode)
    monkeypatch.undo()
    with torch.no_grad():
        assert int4.int4_matmul(x, *targs[1:], mode=mode).shape == (8, 512)
    # 'unroll' and 'dots' keep their gradient
    for other in ('unroll', 'dots'):
        int4.int4_matmul(x, *targs[1:], mode=other).sum().backward()
        assert x.grad is not None
