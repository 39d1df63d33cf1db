"""K11's launch layout, checked on the CPU without nvcc: the grid the
wrapper computes (``decode_grid``) and the kernel's lane → word / byte
mapping, emulated in numpy from the constants ``ops/cuda_kernels.py``
exports, against the plain version and the JAX package's
``_jnp_threshold_decode``; the constants and the shuffle expressions are
parsed from ``csrc/threshold_codec.cu``, so the emulation is the
kernel's. The kernel itself is held against the plain version, bit for
bit, on the card by ``chip_smoke.py``.

Tolerance: none. The decode is a select of +τ, −τ or 0.0, so every
value is compared to the bit.
"""
import inspect
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.ops import pallas_kernels as pk
from deeplearning4j_tpu_torch.ops import cuda_build
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
from deeplearning4j_tpu_torch.ops import kernel_registry

TAU = 0.01171875
#: the leaf sizes: tiny and ragged ones (10 001 and 65 736 end mid-span,
#: as in the card's check), the 768-wide bias, the vocab bias, and the
#: [768, 768] and [768, 2048] weights of the dp_packed step
SIZES = (0, 1, 16, 17, 511, 512, 513, 768, 10001, 50257, 65736, 589824,
         1572864)
@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cu_text() -> str:
    return (cuda_build.CSRC_DIR / "threshold_codec.cu").read_text()


def _words(size, seed=0):
    """Random words (every code 0..3, bit 31 included) for a leaf of
    ``size`` elements, the encoder's word count."""
    n = ck.threshold_words(size)
    return np.random.default_rng(seed).integers(
        0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32).view(np.int32)


def _decode_spans(words, tau, size):
    """The kernel's stores, emulated for every span at once: the float4
    layout (lane l, step j: float4 32j + l from byte l % 4 of word
    8j + l / 4) for the spans wholly inside the leaf, the scalar one
    (lane l, step i: element 32i + l from bits 2(l % 16) of word
    2i + l / 16) for a ragged last span, masked at the leaf's end.
    Returns the values and how many times each element was written."""
    n_words = -(-size // 16)
    n_spans = -(-size // ck.SPAN)
    w = np.zeros(n_spans * ck.SPAN_WORDS, dtype=np.uint32)
    w[:n_words] = words[:n_words].view(np.uint32)
    w = w.reshape(n_spans, ck.SPAN_WORDS)          # lane l loads word l
    tau = np.float32(tau)
    lut = np.array([0.0, tau, -tau, 0.0], dtype=np.float32)
    out = np.zeros(size, dtype=np.float32)
    stores = [np.zeros(0, dtype=np.int64)]
    lane = np.arange(32)
    vec_spans = size // ck.SPAN

    def store(e, code):
        live = e < size
        out[e[live]] = lut[code[live]]
        stores.append(e[live])

    s = np.arange(vec_spans)[:, None]
    for j in range(ck.SPAN // 128):
        b = w[s, 8 * j + (lane >> 2)] >> (8 * (lane & 3)).astype(np.uint32)
        for m in range(4):
            store(s * ck.SPAN + 4 * (32 * j + lane) + m,
                  (b >> np.uint32(2 * m)) & 3)
    s = np.arange(vec_spans, n_spans)[:, None]
    for i in range(ck.SPAN // 32):
        store(s * ck.SPAN + 32 * i + lane,
              (w[s, 2 * i + (lane >> 4)] >> (2 * (lane & 15)).astype(
                  np.uint32)) & 3)
    return out, np.bincount(np.concatenate(stores), minlength=size)


@pytest.mark.parametrize("size", SIZES)
def test_grid_covers_every_word_and_element_once(size):
    n_words = -(-size // 16)
    n_spans = -(-size // ck.SPAN)
    grid = ck.decode_grid(size)
    if size == 0:
        assert grid == 0                    # no launch
        return
    # warp w of the grid takes span w: the fewest blocks that hold a
    # warp for every span
    warps = grid * ck.DECODE_WARPS
    assert n_spans <= warps < n_spans + ck.DECODE_WARPS
    spans = np.arange(warps)
    spans = spans[spans * ck.SPAN < size]   # the others return at once
    np.testing.assert_array_equal(spans, np.arange(n_spans))
    lanes = (spans[:, None] * ck.SPAN_WORDS
             + np.arange(ck.SPAN_WORDS)).ravel()
    words = np.bincount(lanes[lanes < n_words], minlength=n_words)
    assert (words == 1).all()
    # within each span, every element
    _, writes = _decode_spans(np.zeros(ck.threshold_words(size), np.int32),
                              TAU, size)
    assert (writes == 1).all(), size


@pytest.mark.parametrize("size", SIZES)
def test_lane_mapping_equals_plain_and_jax_decode(size):
    words = _words(size, seed=size)
    ref = ck.threshold_decode_reference(torch.tensor(words), TAU, size)
    want = np.asarray(pk._jnp_threshold_decode(jnp.asarray(words), TAU,
                                               size, None))
    np.testing.assert_array_equal(ref.numpy(), want)
    got, _ = _decode_spans(words, TAU, size)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_wrapper_constants_are_the_kernels():
    text = _cu_text()
    const = {name: int(re.search(rf"constexpr int {name} = (\d+);",
                                 text).group(1))
             for name in ("GROUP", "DEC_WARPS", "SPAN_WORDS")}
    assert const["GROUP"] == ck._GROUP == 16
    assert const["DEC_WARPS"] == ck.DECODE_WARPS
    assert const["SPAN_WORDS"] == ck.SPAN_WORDS == 32
    assert "constexpr int SPAN = SPAN_WORDS * GROUP;" in text
    assert ck.SPAN == ck.SPAN_WORDS * ck._GROUP
    assert "constexpr int DEC_THREADS = 32 * DEC_WARPS;" in text
    # the shuffles the emulation copies: the float4 path's source lane
    # and byte, the scalar path's source lane and bit pair
    assert "__shfl_sync(0xffffffffu, word, 8 * j + (lane >> 2))" in text
    assert "w >> (8 * (lane & 3))" in text
    assert "__shfl_sync(0xffffffffu, word, 2 * i + (lane >> 4))" in text
    assert "w >> (2 * (lane & 15))" in text
    assert "o4[32 * j + lane]" in text and "32 * i + lane" in text
    assert "if (left >= SPAN) {" in text     # float4 for a whole span
    # a warp a span, and the C entry's check that the grid holds the leaf
    assert ("s = (long long)blockIdx.x * DEC_WARPS + (threadIdx.x >> 5);"
            in text)
    assert "grid * DEC_WARPS * SPAN < size" in text


def test_registry_row_names_the_cuda_source():
    (row,) = [e for e in kernel_registry.KERNELS if e.key == "K11"]
    assert row.status == "ported" and row.route == "cuda"
    assert row.source == "deeplearning4j_tpu_torch/csrc/threshold_codec.cu"
    assert row.port_fn() is ck.threshold_decode
    assert row.plain_fn() is ck.threshold_decode_reference


def test_c_entry_refuses_an_unaligned_out():
    """The float4 stores need a 16-byte aligned output: the wrapper's own
    allocation always is, and the C entry returns -1 for any other
    before it launches anything (the card's check calls it so)."""
    text = _cu_text()
    entry = text[text.index("int dl4j_threshold_decode("):]
    refuse = entry.index("!aligned16(out, out))\n    return -1;")
    assert refuse < entry.index("<<<")
    assert "out" not in inspect.signature(ck.threshold_decode).parameters
