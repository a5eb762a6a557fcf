"""The plan of kernel 8's wgmma design (`ops/int4.mma_plan`) on the CPU:
the instance n it picks for M rows, its column tiles, and how its blocks
share the (column tile, step) units: every unit to exactly one block, a
non-empty run for each, every tile's steps covered once, in block order,
by at most `parts` blocks, and no block the last of two split tiles, as
the kernel's `unit_start` / `unit_block` cut them (mirrored here by their
integer formulas). Also what the wrapper hands the kernel's entry point,
and the workspace it keeps a device. The kernel itself is held against
the plain version on the card (tests/test_torch_cuda.py, chip_smoke.py
phase 2)."""

import pytest
import torch

from evo_tpu_torch.ops import int4

# evo-1's four weight shapes as (Kp, N): w1 / w2, w3, w_in / wqkv, w_out
EVO_SHAPES = [(4096, 10928), (11008, 4096), (4096, 12288), (4096, 4096)]
RAGGED = [(1024, 1001), (4352, 600), (512, 136), (256, 24)]
ROWS = (5, 8, 9, 16, 17, 32, 33, 64, 65, 128)


def unit_start(b, U, G):
    """The kernel's `unit_start`: block b's first unit."""
    return b * U // G


@pytest.mark.parametrize('Kp,N', EVO_SHAPES + RAGGED)
@pytest.mark.parametrize('M', ROWS)
def test_mma_plan_covers_every_step_once(M, Kp, N):
    n, cols, blocks, parts = int4.mma_plan(M, Kp, N)
    # the smallest instance that holds M rows, and its column tile
    assert n == min(c for c in (16, 32, 64, 128) if c >= M)
    assert cols == (256 if n <= 32 else 128)
    T, tiles = Kp // 256, -(-N // cols)
    U = tiles * T
    assert blocks == min(U, int4.SMS)
    if (Kp, N) in EVO_SHAPES:
        assert blocks >= 132          # an SM each on an H100
    # block b takes units [start(b), start(b + 1)): none empty, none twice
    starts = [unit_start(b, U, blocks) for b in range(blocks + 1)]
    assert starts[0] == 0 and starts[-1] == U
    assert all(a < b for a, b in zip(starts, starts[1:]))
    owner = [b for b in range(blocks)
             for _u in range(starts[b], starts[b + 1])]
    assert len(owner) == U
    # the kernel's `unit_block` names each unit's block
    assert [int4._unit_block(u, U, blocks) for u in range(U)] == owner
    most = 0
    ends = [0] * blocks
    for t in range(tiles):
        steps = owner[t * T:(t + 1) * T]
        # a tile's steps go to consecutive blocks, in step order
        assert steps == sorted(steps)
        assert set(steps) == set(range(steps[0], steps[-1] + 1))
        most = max(most, steps[-1] - steps[0] + 1)
        if steps[0] != steps[-1]:
            ends[steps[-1]] += 1
    # the kernel holds one split tile a block to add up at the end
    assert max(ends) <= 1
    # `parts`: the most blocks any tile is cut between, or 0 when every
    # block takes whole tiles (the kernel then needs no workspace)
    whole = U % blocks == 0 and (U // blocks) % T == 0
    assert parts == (0 if whole else most)
    if whole:
        assert most == 1
    # the tickets: one a column tile
    assert int4._tickets(torch.device('cpu'), tiles).numel() >= tiles


@pytest.mark.parametrize('sms', [1, 7, 66, 132, 1000])
def test_mma_plan_on_other_cards(sms):
    """Fewer or more SMs than the H100's: at most one block a unit, every
    unit to one block, and `parts` bounds every tile's blocks."""
    for M in (9, 128):
        for Kp, N in EVO_SHAPES + RAGGED:
            _n, cols, blocks, parts = int4.mma_plan(M, Kp, N, sms)
            T = Kp // 256
            U = -(-N // cols) * T
            assert blocks == min(U, sms)
            for t in range(U // T):
                first = int4._unit_block(t * T, U, blocks)
                last = int4._unit_block(t * T + T - 1, U, blocks)
                assert last - first + 1 <= max(parts, 1)


def test_designs_split_at_the_crossover():
    """The streaming design takes M <= GEMV_M_MAX rows, the wgmma design
    the rest; both are one function, so the plain version answers for
    either on the CPU."""
    assert int4.GEMV_M_MAX == 2
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 512, generator=g).bfloat16()
    q = torch.randint(-8, 8, (512, 64), generator=g, dtype=torch.int8)
    s = torch.rand(4, 64, generator=g) * 0.09 + 0.01
    packed = int4.pack_int4(q)
    got = int4.int4_matmul(x, packed, s)
    want = (x.float() @ (int4.unpack_int4(packed).float().reshape(4, 128, 64)
                         * s[:, None]).reshape(512, 64))
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.parametrize('M,K,Kp,N', [
    (1, 4096, 4096, 12288), (2, 4096, 4096, 4096), (3, 4096, 4096, 12288),
    (9, 10928, 11008, 4096), (128, 4096, 4096, 10928), (40, 130, 512, 136),
    (5, 256, 256, 512)])
def test_kernel_wrapper_launches_the_plan(monkeypatch, M, K, Kp, N):
    """What the wrapper hands the kernel's entry point, recorded in place
    of the launch: the streaming design up to GEMV_M_MAX rows with its
    Kp / 256 splits, else the wgmma design on `mma_plan`'s blocks; a
    workspace and the tickets exactly when a tile is split, the workspace
    the device's kept one and large enough for the parts; x padded to Kp
    when K % 8 != 0 under the wgmma design."""
    calls = []
    monkeypatch.setattr(int4._build, 'launch',
                        lambda name, counter, *args: calls.append(args))
    monkeypatch.setattr(int4._build, 'sm_count', lambda index: int4.SMS)
    g = torch.Generator().manual_seed(M)
    x = torch.randn(M, K, generator=g).bfloat16()
    packed = torch.randint(-128, 128, (Kp // 2, N), generator=g,
                           dtype=torch.int8)
    s = torch.rand(Kp // 128, N, generator=g)
    int4.int4_matmul_kernel(x, packed, s, torch.bfloat16)
    (_x, _p, _s, _y, part, tickets, m, k, kp, n, bf16, gemv, block,
     blocks), = calls
    assert (m, kp, n, bf16, block) == (M, Kp, N, 1, 0)
    assert gemv == int(M <= int4.GEMV_M_MAX)
    if gemv:
        assert blocks == 0 and k == K
        parts = Kp // 256 if Kp // 256 > 1 else 0
    else:
        _n, _cols, want_blocks, parts = int4.mma_plan(M, Kp, N)
        assert blocks == want_blocks and k == (K if K % 8 == 0 else Kp)
    assert (part is not None) == (parts > 0) == (tickets is not None)
    if parts:
        kept = int4._WORKSPACE[x.device][-1]
        assert part == kept.data_ptr() and kept.numel() >= parts * M * N
        assert kept.dtype == torch.float32


def test_kernel_wrapper_keeps_its_workspace(monkeypatch):
    """The split tiles' partial sums go to one buffer a device, allocated
    once and not on every call: calls that fit take the same buffer; a
    larger call gets a larger one, and the outgrown buffer stays held (a
    CUDA graph may have captured its address)."""
    parts = []
    monkeypatch.setattr(int4._build, 'launch',
                        lambda name, counter, *args: parts.append(args[4]))
    monkeypatch.setattr(int4._build, 'sm_count', lambda index: int4.SMS)
    monkeypatch.setattr(int4, '_WORKSPACE', {})
    g = torch.Generator().manual_seed(0)

    def call(M, Kp, N):
        x = torch.randn(M, Kp, generator=g).bfloat16()
        packed = torch.randint(-128, 128, (Kp // 2, N), generator=g,
                               dtype=torch.int8)
        s = torch.rand(Kp // 128, N, generator=g)
        int4.int4_matmul_kernel(x, packed, s, torch.bfloat16)
        return parts[-1]
    first = call(8, 4096, 4096)
    assert int4.mma_plan(8, 4096, 4096)[3] > 0
    # another row count, another design: the same buffer
    assert call(9, 4096, 4096) == call(2, 4096, 4096) == first
    # more than 2^20 floats of parts: a new buffer, the old one kept
    M, Kp, N = 128, 4096, 10928
    assert int4.mma_plan(M, Kp, N)[3] * M * N > 1 << 20
    grown = call(M, Kp, N)
    held = int4._WORKSPACE[torch.device('cpu')]
    assert grown != first and [t.data_ptr() for t in held] == [first, grown]
    assert call(8, 4096, 4096) == grown
