"""PyTorch port: the vision projector registry (models/projectors.py)
against the JAX package in float32 (tolerance 1e-4): every kind on a 4x4
token grid, SPP and LDP also on 24x24 and 27x27 grids (the even grid pins
LDP's stride-2 "SAME" padding, (0, 1); the odd one SPP's floor), the token
reductions, init structure, errors, and the HF round trip of every kind
both ways between the packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (pins torch threads)
from torch_port_util import close, normal, t
from vita_tpu.models import projectors as j_proj
from vita_tpu.utils import hf_import as j_hf
from vita_tpu_torch.models import projectors
from vita_tpu_torch.utils import hf_import

IN_DIM, LLM_DIM = 24, 40


def _params(kind, seed=0):
    """(JAX params, the same as port tensors) of ``kind``; LayerNorm
    weights and biases drawn too, so that they count."""
    jp = j_proj.init_vision_projector_kind(jax.random.PRNGKey(seed), IN_DIM, LLM_DIM, kind)
    rng = np.random.default_rng(seed)
    jp = jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.asarray(1 + 0.1 * normal(rng, *a.shape))
        if "ln" in jax.tree_util.keystr(p) else a, jp)
    return jp, jax.tree.map(lambda a: t(np.asarray(a)), jp)


CASES = [(k, 16) for k in projectors.PROJECTOR_KINDS] + [
    (k, n) for k in ("spp_v1", "spp_v2", "spp_v3", "ldp") for n in (576, 729)]


@pytest.mark.parametrize("kind,tokens", CASES)
def test_projector_matches_jax(kind, tokens):
    jp, tp = _params(kind)
    feats = normal(np.random.default_rng(tokens), 2, tokens, IN_DIM)
    got = projectors.apply_vision_projector(tp, t(feats), kind)
    want = j_proj.apply_vision_projector(jp, jnp.asarray(feats), kind)
    assert got.shape == want.shape
    close(got, want)
    assert projectors.projector_token_reduction(kind) == j_proj.projector_token_reduction(kind)


def test_registry_and_init_structure_match_jax():
    assert projectors.PROJECTOR_KINDS == j_proj.PROJECTOR_KINDS
    for kind in projectors.PROJECTOR_KINDS + ("spp_v1_big",):
        got = projectors.init_vision_projector_kind(IN_DIM, LLM_DIM, torch.Generator(), kind)
        want = j_proj.init_vision_projector_kind(jax.random.PRNGKey(0), IN_DIM, LLM_DIM, kind)
        shapes = lambda tree: jax.tree.map(lambda a: tuple(a.shape), tree)
        assert shapes(got) == shapes(want), kind


def test_ldp_same_padding_is_xla_s():
    """The stride-2 depthwise conv of an even grid pads (0, 1) as XLA's
    "SAME" does: padding (1, 1) would shift every output pixel."""
    assert projectors._same_pad(24, 2) == (0, 1) and projectors._same_pad(27, 2) == (1, 1)
    assert projectors._same_pad(24, 1) == (1, 1)


@pytest.mark.parametrize("kind,msg", [("spp_v9", "unknown spp variant"),
                                      ("resampler", "unknown projector kind")])
def test_unknown_kinds_raise_as_jax(kind, msg):
    with pytest.raises(ValueError, match=msg):
        projectors.init_vision_projector_kind(IN_DIM, LLM_DIM, torch.Generator(), kind)
    with pytest.raises(ValueError, match=msg):
        j_proj.init_vision_projector_kind(jax.random.PRNGKey(0), IN_DIM, LLM_DIM, kind)
    with pytest.raises(ValueError, match="unknown"):
        projectors.apply_vision_projector({}, torch.zeros(1, 16, IN_DIM), kind)


@pytest.mark.parametrize("kind,tokens", [("vanilla", 18), ("ldp", 15)])
def test_bad_token_counts_raise(kind, tokens):
    _, tp = _params(kind)
    with pytest.raises(ValueError):
        projectors.apply_vision_projector(tp, torch.zeros(1, tokens, IN_DIM), kind)


@pytest.mark.parametrize("kind", projectors.PROJECTOR_KINDS)
def test_projector_hf_round_trip_both_ways(kind):
    """vision_projector_to_hf / _from_hf: the port's export is the JAX
    package's, name for name and bit for bit; each package imports the
    other's export into the same leaves."""
    jp, tp = _params(kind, seed=1)
    got, want = hf_import.vision_projector_to_hf(tp, kind), j_hf.vision_projector_to_hf(jp, kind)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k].numpy(), want[k]), k
    template = projectors.init_vision_projector_kind(IN_DIM, LLM_DIM, None, kind, device="meta")
    jtemplate = j_proj.init_vision_projector_kind(jax.random.PRNGKey(0), IN_DIM, LLM_DIM, kind)
    back = hf_import.vision_projector_from_hf(want, kind=kind, template=template)
    jback = j_hf.vision_projector_from_hf({k: v.numpy() for k, v in got.items()}, kind=kind,
                                          template=jtemplate)
    for tree in (back, jax.tree.map(lambda a: t(np.asarray(a)), jback)):
        flat_t, flat_w = (jax.tree_util.tree_leaves_with_path(x) for x in (tree, tp))
        assert [p for p, _ in flat_t] == [p for p, _ in flat_w]
        for (path, a), (_, b) in zip(flat_t, flat_w):
            assert torch.equal(a, b), path
    if kind not in ("mlp2x_gelu", "identity"):
        with pytest.raises(ValueError, match="template"):
            hf_import.vision_projector_from_hf(want, kind=kind)
