"""The sharded train step's memory in the JAX package's layout: the loss
over a vocab cut over `model` without gathering the logits, held on gloo
ranks against the gathered loss; and the dry run's bytes a device for
tinyllama-1.1b train_4k on pod16x16 against the JAX package's committed
record (`tests/test_torch_dryrun.py` holds the committed port record equal
to a fresh dry run). The rank worker is `torch_tp_ranks.vocab_loss_rank`."""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

import torch_tp_ranks as ranks
from repro_torch.configs import reduced
from repro_torch.launch import mesh as tmesh

ROOT = Path(__file__).resolve().parents[1]
ROWS, SEQ, VOCAB = 4, 16, 500  # 500 pads to 512: the last model rank holds 12 pad slots
TOL = 1e-6                     # of each quantity's max abs, fp32


@pytest.fixture(scope="module")
def loss_inputs():
    cfg = dataclasses.replace(reduced("tinyllama-1.1b"), dtype="float32", vocab=VOCAB,
                              tie_embeddings=False)
    rng = np.random.default_rng(7)
    w = (rng.standard_normal((cfg.d_model, cfg.padded_vocab)) * 0.5).astype(np.float32)
    x = rng.standard_normal((ROWS, SEQ, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, VOCAB, (ROWS, SEQ)).astype(np.int32)
    labels[0, :3] = -100
    labels[-1, -5:] = -100
    labels[1, :4] = VOCAB - 1  # gold logits in the last rank's columns
    return cfg, w, x, labels


def _close(got, want):
    scale = max(float(np.max(np.abs(want))), 1e-30)
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want)))) <= TOL * scale


_SPAWNS = {}
CHUNKS = (SEQ // 2, SEQ)  # two checkpointed chunks, and one


def _ranks(loss_inputs, shape):
    """One spawn of gloo ranks a mesh, for both chunk sizes."""
    if shape not in _SPAWNS:
        cfg, w, x, labels = loss_inputs
        _SPAWNS[shape] = tmesh.run_ranks(ranks.vocab_loss_rank, shape[0] * shape[1],
                                         (shape, cfg, w, x, labels, CHUNKS), device="cpu",
                                         timeout=120)
    return _SPAWNS[shape]


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
@pytest.mark.parametrize("chunk", CHUNKS)
def test_vocab_parallel_loss_equals_the_gathered_loss(loss_inputs, shape, chunk):
    """Loss, nll, z term and the gradients of each rank's x and head
    columns: the cut logits' loss (`ctx.vocab_xent`) against the logits
    gathered over the vocab, within 1e-6 of each one's max abs; in two
    checkpointed chunks and in one."""
    for r in _ranks(loss_inputs, shape):
        cut, ref = r[chunk, "cut"], r[chunk, "gathered"]
        for k in ("nll", "z2", "loss", "gx", "gw"):
            assert _close(cut[k], ref[k]), (k, shape)
        assert np.abs(ref["gw"]).max() > 0


def test_dryrun_bytes_a_device_within_twice_the_reference():
    """tinyllama-1.1b train_4k on pod16x16: the committed port record's
    bytes a device at most twice the JAX package's committed record's (the
    carry cut over `model` between blocks, the loss's logits cut over the
    vocab); 26.86 GiB before either."""
    mine = json.loads((ROOT / "results/dryrun_torch/tinyllama-1.1b__train_4k__pod16x16.json")
                      .read_text())
    ref = json.loads((ROOT / "results/dryrun/tinyllama-1.1b__train_4k__pod16x16.json")
                     .read_text())
    assert mine["status"] == "ok"
    assert mine["bytes_per_device"] <= 2 * ref["bytes_per_device"]
