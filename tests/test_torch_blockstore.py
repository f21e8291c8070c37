"""The port's threaded block writer and reader against the JAX package's.

``write_blockstore`` compresses blocks on a thread pool and streams them to
the file in order; the file must be byte for byte the one a single thread
writes and the one ``repro.core.blockstore.write_blockstore`` writes, for
each codec and level.  ``BlockReader`` decompresses each contiguous run on a
pool; the bytes, ``ReadStats`` and ``file_reads`` must be those of one
worker.  Payloads are N(0, 0.02) float32 bytes drawn with numpy from a seed,
as model weights are.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import blockstore as jbs
from repro_torch.core import blockstore as tbs

BS = 4096  # small blocks: many per payload, fast
PAYLOADS = {
    "empty": 0,
    "one_partial_block": 1000,
    "exact_multiple": 6 * BS,
    "ragged_tail": 37 * BS + 1234,
}
CODECS = ["zlib", pytest.param("zstd", marks=pytest.mark.skipif(
    not tbs.have_zstd(), reason="zstandard is not installed"))]


def _payload(n: int, seed: int = 0) -> bytes:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(-(-n // 4)) * 0.02).astype(np.float32).tobytes()[:n]


def _write(mod, payload, path, **kw):
    manifest = mod.write_blockstore(payload, str(path), **kw)
    return manifest, path.read_bytes()


@pytest.mark.parametrize("workers", [1, 2, 7])
@pytest.mark.parametrize("name", list(PAYLOADS))
@pytest.mark.parametrize("codec", CODECS)
def test_threaded_writer_is_byte_identical(tmp_path, codec, name, workers):
    payload = _payload(PAYLOADS[name])
    want_m, want = _write(jbs, payload, tmp_path / "jax.blocks", block_size=BS, codec=codec)
    serial_m, serial = _write(tbs, payload, tmp_path / "serial.blocks", block_size=BS, codec=codec,
                              workers=1)
    got_m, got = _write(tbs, payload, tmp_path / "threads.blocks", block_size=BS, codec=codec,
                        workers=workers)
    assert got == serial == want
    assert dataclasses.asdict(got_m) == dataclasses.asdict(serial_m) == dataclasses.asdict(want_m)
    assert got_m.n_blocks == max(1, -(-len(payload) // BS))
    assert not list(tmp_path.glob("*.tmp"))


@pytest.mark.parametrize("level", [1, 9])
@pytest.mark.parametrize("codec", CODECS)
def test_threaded_writer_at_a_pinned_level(tmp_path, codec, level):
    payload = _payload(PAYLOADS["ragged_tail"], seed=1)
    _, want = _write(jbs, payload, tmp_path / "jax.blocks", block_size=BS, codec=codec, level=level)
    _, got = _write(tbs, payload, tmp_path / "port.blocks", block_size=BS, codec=codec, level=level,
                    workers=7)
    assert got == want


def test_threaded_writer_at_the_default_block_size(tmp_path):
    payload = _payload(3 * tbs.DEFAULT_BLOCK_SIZE + 4321, seed=2)
    _, want = _write(jbs, payload, tmp_path / "jax.blocks", codec="zlib")
    _, got = _write(tbs, payload, tmp_path / "port.blocks", codec="zlib", workers=4)
    assert got == want


def test_chunks_are_cut_across_their_boundaries(tmp_path):
    """Chunks of every awkward size (empty, under a block, spanning several,
    numpy arrays and views) give the file of their concatenation."""
    payload = _payload(11 * BS + 17, seed=3)
    cuts = [0, 0, 5, BS - 5, BS + 3, 4 * BS, 4 * BS, 7 * BS + 1, len(payload)]
    chunks = [payload[a:b] for a, b in zip(cuts, cuts[1:])]
    chunks[2] = np.frombuffer(chunks[2], np.uint8)
    chunks[3] = memoryview(chunks[3])
    _, want = _write(tbs, payload, tmp_path / "whole.blocks", block_size=BS, codec="zlib", workers=1)
    path = tmp_path / "chunks.blocks"
    tbs.write_blockstore_chunks(chunks, len(payload), str(path), block_size=BS, codec="zlib", workers=3)
    assert path.read_bytes() == want


@pytest.mark.parametrize("declared", [-1, 1, BS])
def test_chunks_that_miss_raw_size_raise(tmp_path, declared):
    payload = _payload(3 * BS + 9, seed=4)
    path = tmp_path / "bad.blocks"
    with pytest.raises(ValueError, match="raw_size"):
        tbs.write_blockstore_chunks([payload], len(payload) + declared, str(path), block_size=BS,
                                    codec="zlib", workers=2)
    assert not path.exists()


def _reads(path, workers, ranges):
    with tbs.BlockReader(str(path), workers=workers) as r:
        out = [r.read_range(o, n) for o, n in ranges]
        return out, dataclasses.asdict(r.stats), r.file_reads, dict(r._cache)


@pytest.mark.parametrize("workers", [2, 7])
@pytest.mark.parametrize("codec", CODECS)
def test_threaded_reader_matches_one_worker(tmp_path, codec, workers):
    payload = _payload(PAYLOADS["ragged_tail"], seed=5)
    path = tmp_path / "p.blocks"
    tbs.write_blockstore(payload, str(path), block_size=BS, codec=codec)
    n = len(payload)
    # a middle range first leaves a cached hole, so the full read splits
    # into two runs around it; then a range inside the cache, then the tail
    ranges = [(10 * BS + 7, 3 * BS), (0, n), (2 * BS + 1, 5), (n - 100, 100), (0, 0)]
    got, stats, reads, cache = _reads(path, workers, ranges)
    want, want_stats, want_reads, want_cache = _reads(path, 1, ranges)
    assert got == want
    assert got[1] == payload
    assert stats == want_stats
    assert reads == want_reads == 3
    assert cache == want_cache
    with jbs.BlockReader(str(path)) as ref:
        assert [ref.read_range(o, k) for o, k in ranges] == want
        assert dataclasses.asdict(ref.stats) == stats
        assert ref.file_reads == reads


def test_threaded_reader_reads_a_jax_file(tmp_path):
    payload = _payload(9 * BS + 1, seed=6)
    path = tmp_path / "j.blocks"
    jbs.write_blockstore(payload, str(path), block_size=BS, codec="zlib")
    with tbs.BlockReader(str(path), workers=4) as r:
        assert r.read_all() == payload
        assert r.stats.blocks_fetched == 10 and r.file_reads == 1


def test_default_workers_are_the_usable_cores():
    import os

    assert tbs.default_workers() == len(os.sched_getaffinity(0)) >= 1
