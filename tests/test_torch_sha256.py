"""fabric_tpu_torch.ops.sha256 against fabric_tpu.ops.sha256 and hashlib.

The host pack must be byte-identical to the JAX package's (error text
included); the plain torch `sha256_blocks` must give hashlib's digests,
with garbage in every block past a lane's count. Inputs are seeded
numpy bytes; tolerance: exact equality. The CUDA digest-only kernel is
held to the plain version by tests/test_torch_cuda.py and chip_smoke.py
on the card.
"""

import hashlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fabric_tpu.ops import fused_verify as jfv
from fabric_tpu.ops import sha256 as jsha

from fabric_tpu_torch.ops import sha256 as tsha

EDGE_LENS = (0, 1, 55, 56, 63, 64, 119, 120, 503)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _msgs(seed: int, nb: int, B: int):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, tsha.max_message_len(nb) + 1, size=B)
    msgs = [rng.bytes(int(n)) for n in lens]
    fit = [n for n in EDGE_LENS if n <= tsha.max_message_len(nb)]
    for j, n in enumerate(fit):
        msgs[j] = rng.bytes(n)
    return msgs


def _garbage_past_counts(blocks, counts, seed: int):
    rng = np.random.default_rng(seed)
    past = np.arange(blocks.shape[1])[None, :] >= counts[:, None]
    blocks[past] = rng.integers(0, 1 << 32, size=(int(past.sum()), 16),
                                dtype=np.uint32)
    return past


def _hashlib_words(msgs) -> np.ndarray:
    return np.stack([np.frombuffer(hashlib.sha256(m).digest(), ">u4")
                     for m in msgs]).astype(np.int64)


def test_constants_match_jax():
    np.testing.assert_array_equal(tsha._K, jsha._K)
    np.testing.assert_array_equal(tsha._H0, jsha._H0)
    np.testing.assert_array_equal(tsha.sha_consts(), jfv._sha_consts())
    assert tsha.sha_consts().dtype == np.uint32
    for nb in (1, 2, 8, 64):
        assert tsha.max_message_len(nb) == jsha.max_message_len(nb)


@pytest.mark.parametrize("nb", [1, 2, 8])
def test_pack_messages_byte_identical_to_jax(nb):
    msgs = _msgs(nb, nb, 40)
    got, got_n = tsha.pack_messages(msgs, nb)
    want, want_n = jsha.pack_messages(msgs, nb)
    assert got.dtype == want.dtype == np.uint32
    assert got.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_n, want_n)
    assert got_n.dtype == want_n.dtype


def test_pack_messages_errors_and_empty_batch():
    msgs = [b"a", b"x" * 100, b"y" * 200]
    with pytest.raises(ValueError) as got:
        tsha.pack_messages(msgs, 1)
    with pytest.raises(ValueError) as want:
        jsha.pack_messages(msgs, 1)
    assert str(got.value) == str(want.value)
    blocks, counts = tsha.pack_messages([], 2)
    assert blocks.shape == (0, 2, 16) and counts.shape == (0,)


@pytest.mark.parametrize("as_int32", [False, True])
def test_sha256_blocks_plain_matches_hashlib(as_int32):
    """The edge lengths and random ones at NB = 8, garbage in every block
    past a lane's count (it must not move the state), a lane with no
    live block (the initial state, as the JAX loop gives)."""
    msgs = _msgs(8, 8, 24)
    blocks, counts = tsha.pack_messages(msgs, 8)
    past = _garbage_past_counts(blocks, counts, seed=3)
    assert past.any()
    counts[5] = 0
    if as_int32:
        blocks = blocks.view(np.int32)
    before = tsha.launches
    got = tsha.sha256_blocks(torch.from_numpy(blocks),
                             torch.from_numpy(counts))
    assert got.dtype == torch.int64 and got.shape == (24, 8)
    want = _hashlib_words(msgs)
    want[5] = tsha._H0
    np.testing.assert_array_equal(got.numpy(), want)
    assert tsha.launches == before        # the plain version is no launch


def test_sha256_host_matches_hashlib():
    msgs = [b"", b"abc", b"m" * 200, b"x" * tsha.max_message_len(2)]
    for nb in (None, 4):
        got = tsha.sha256_host(msgs, nb=nb, device="cpu")
        assert got.dtype == np.uint32
        np.testing.assert_array_equal(got, _hashlib_words(msgs))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsha.sha256_host(msgs)              # the card unless asked


def test_wrapper_rejects_bad_inputs():
    blocks, counts = (torch.from_numpy(a)
                      for a in tsha.pack_messages([b"a", b"b"], 1))
    with pytest.raises(ValueError):
        tsha.sha256_blocks(blocks[..., :15], counts)
    with pytest.raises(ValueError):
        tsha.sha256_blocks(blocks[:, :0], counts)
    with pytest.raises(ValueError):
        tsha.sha256_blocks(blocks, counts[:1])
    with pytest.raises(TypeError):
        tsha.sha256_blocks(blocks.to(torch.int64), counts)
    with pytest.raises(TypeError):
        tsha.sha256_blocks(blocks, counts.to(torch.int64))
    with pytest.raises(ValueError):
        tsha.sha256_blocks(blocks.to("meta"), counts.to("meta"))


def test_sha256_blocks_matches_jax_jit():
    """Against jax.jit(sha256_blocks) itself (its scans compile in about
    a second on the CPU), garbage past the counts included."""
    msgs = _msgs(4, 4, 16)
    blocks, counts = tsha.pack_messages(msgs, 4)
    _garbage_past_counts(blocks, counts, seed=4)
    want = np.asarray(jax.jit(jsha.sha256_blocks)(jnp.asarray(blocks),
                                                  jnp.asarray(counts)))
    got = tsha.sha256_blocks(torch.from_numpy(blocks),
                             torch.from_numpy(counts))
    np.testing.assert_array_equal(got.numpy(), want)
