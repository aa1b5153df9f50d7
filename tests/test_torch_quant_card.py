"""Kernel pair Q1 on a card (``csrc/quant.cu``): encode and decode against
their plain versions on the same card, bit for bit.

The cases are those of ``tests/test_torch_quant.py`` (normal data, zero
tiles, NaN and ±inf tiles, a ragged last tile, rounding ties, a wide range
of magnitudes, −0.0, subnormals) plus rows whose length is no multiple of 4
(the scalar loads) and a large batch. Encode must give the plain version's
int8 codes and scale bytes exactly (the kernel divides as IEEE does and
rounds half to even as ``torch.round`` does); decode its float32 words.
Each call launches once and adds one to its count; a CUDA tensor never
takes the plain version. The bf16 mode is ATen's cast on either device and
is checked against the CPU's words (NaN's pattern apart).

This module imports neither JAX nor heat_tpu: on the card run it as
``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_quant_card.py``. Without a card every test skips.
"""

import numpy as np
import pytest
import torch

from heat_tpu_torch.kernels import quant

pytestmark = pytest.mark.cuda


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: Q1 has no CPU mode")
    return torch.device("cuda")


def _cases():
    rng = np.random.default_rng(0)
    out = {"normal": rng.standard_normal((3, 2500)) * 7}
    z = rng.standard_normal((2, 3072))
    z[0, 1024:2048] = 0.0
    z[1] = 0.0
    out["zero_tiles"] = z
    s = rng.standard_normal((3, 2048))
    s[0, 5], s[0, 6], s[0, 7], s[1, 9] = np.nan, -np.nan, np.inf, -np.inf
    s[1, 1500:1600] = np.nan
    s[2, :1024] = np.inf
    out["specials"] = s
    out["ragged"] = rng.standard_normal((4, 1030))
    out["odd_rows"] = rng.standard_normal((7, 1027))  # rows not on 16 bytes: the scalar loads
    out["tiny_row"] = rng.standard_normal((5, 3))
    out["ties"] = (np.arange(2048).reshape(2, 1024) - 1000) * 0.5
    out["wide_range"] = rng.standard_normal((2, 4096)) * 10.0 ** rng.integers(-30, 30, (2, 4096))
    out["neg_zero"] = np.full((1, 1024), -0.0)
    out["subnormal"] = rng.standard_normal((2, 1500)) * 1e-39
    out["batch"] = rng.standard_normal((64, 65536))
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


CASES = _cases()


@pytest.mark.parametrize("case", list(CASES))
def test_q1_equals_its_plain_version_bit_for_bit(case):
    dev = _card()
    x = torch.from_numpy(CASES[case]).to(dev)
    e0, d0 = quant.ENCODE_LAUNCHES, quant.DECODE_LAUNCHES
    w = quant.encode_blocks(x, "int8")
    assert quant.ENCODE_LAUNCHES == e0 + 1 and w.device == x.device
    want = quant.encode_int8_plain(x)
    assert torch.equal(w, want)
    back = quant.decode_blocks(w, x.shape[1], "int8")
    assert quant.DECODE_LAUNCHES == d0 + 1
    assert torch.equal(back.view(torch.int32), quant.decode_int8_plain(want, x.shape[1]).view(torch.int32))
    cpu = quant.encode_blocks(x.cpu(), "int8")
    assert torch.equal(w.cpu(), cpu)  # the card's wire is the CPU's


def test_q1_on_a_view_and_an_empty_batch():
    dev = _card()
    x = torch.from_numpy(CASES["normal"]).to(dev)[:, 7:]  # a view that is not contiguous
    assert torch.equal(quant.encode_blocks(x, "int8"), quant.encode_int8_plain(x.contiguous()))
    e0 = quant.ENCODE_LAUNCHES
    assert quant.encode_blocks(torch.empty((0, 100), device=dev), "int8").shape == (0, 1028)
    assert quant.ENCODE_LAUNCHES == e0  # nothing to encode: no launch


def test_bf16_mode_on_the_card_gives_the_cpus_words():
    """ATen's cast on the card: the CPU's words but for NaN's pattern (the
    card's cast writes 0x7fff, the CPU's route XLA's 0x7fc0), NaN either way."""
    dev = _card()
    x = torch.from_numpy(CASES["specials"])
    card = quant.encode_blocks(x.to(dev), "bf16").cpu().view(torch.int16)
    cpu = quant.encode_blocks(x, "bf16").view(torch.int16)
    nan = torch.isnan(x)
    assert torch.equal(card[~nan], cpu[~nan])
    assert torch.isnan(card.view(torch.bfloat16)[nan]).all()
    back = quant.decode_blocks(card.view(torch.int8).to(dev), x.shape[1], "bf16").cpu()
    assert torch.equal(torch.isnan(back), nan)
