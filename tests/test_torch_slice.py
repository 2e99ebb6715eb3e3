"""The port's PCN evaluation slice as a whole vs the JAX package on the CPU:
a tiny SVDFormer (step 2/2, merge and local 128) with the same random
weights, B 2, N 512, gt 1024, 32² render. The JAX side is built and run once
per module (eval_shape for the weights, one jit of apply)."""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_parity import close, jax_reference_modes, jax_variables, load_port, t  # noqa: F401
from svdformer_pointsea_tpu.nn import SVDFormer as JaxSVDFormer
from svdformer_pointsea_tpu.render import PCViews as JaxPCViews
from svdformer_pointsea_tpu.train.evaluate import _per_sample_metrics as jax_metrics
from svdformer_pointsea_tpu_torch.configs import pcn_config
from svdformer_pointsea_tpu_torch.nn import SVDFormer
from svdformer_pointsea_tpu_torch.render import make_renderer
from svdformer_pointsea_tpu_torch.train.evaluate import eval_pcn, make_pcn_eval_fn

TINY = dict(step1=2, step2=2, merge_points=128, local_points=128)
COMPLETION_ATOL = 2e-3  # tests/test_reference_parity.py's bound for whole-model outputs
CD_GATE = 0.01  # |ΔCD-L1×10³| (docs/PARITY.md)

pytestmark = pytest.mark.usefixtures("jax_reference_modes")


@pytest.fixture(scope="module")
def slice_case(jax_reference_modes):
    rng = np.random.RandomState(7)
    partial = ((rng.rand(2, 512, 3) - 0.5) * 0.8).astype(np.float32)
    gt = ((rng.rand(2, 1024, 3) - 0.5) * 0.8).astype(np.float32)
    depth = np.asarray(JaxPCViews(trans=-0.7, resolution=32).get_img(jnp.asarray(partial)))
    jmodel = JaxSVDFormer(**TINY)
    variables = jax_variables(jmodel, partial, depth, seed=1)
    outs = [np.asarray(o) for o in jax.jit(jmodel.apply)(variables, partial, depth)]
    metrics = np.stack([np.asarray(m) for m in jax.jit(jax_metrics, static_argnums=2)(
        jnp.asarray(outs[-1]), jnp.asarray(gt), True)])
    cfg = pcn_config()
    cfg = cfg.replace(network=dataclasses.replace(cfg.network, resolution=32, **TINY))
    model = load_port(SVDFormer.from_config(cfg.network), variables)
    return SimpleNamespace(partial=partial, gt=gt, outs=outs, metrics=metrics, cfg=cfg, model=model)


def test_slice_completions_match_jax(slice_case):
    c = slice_case
    render = make_renderer(c.cfg)
    with torch.inference_mode():
        outs = c.model(t(c.partial), render.get_img(t(c.partial)))
    for got, want, n in zip(outs, c.outs, (256, 256, 512)):
        assert got.shape == (2, n, 3)
        close(got, want, atol=COMPLETION_ATOL)


def test_slice_eval_fn_metrics_match_jax(slice_case):
    c = slice_case
    got = make_pcn_eval_fn(c.model, make_renderer(c.cfg))(t(c.partial), t(c.gt)).numpy()
    assert got.shape == (3, 2) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got[0], c.metrics[0], atol=CD_GATE)
    np.testing.assert_allclose(got[1:], c.metrics[1:], atol=1e-3)


def test_eval_pcn_table_and_mean(slice_case, capsys):
    c = slice_case
    data = {"partial_cloud": c.partial, "gtcloud": c.gt}
    batches = [SimpleNamespace(data=data, taxonomy_ids=["a", "b"], valid=2),
               SimpleNamespace(data=data, taxonomy_ids=["a", "b"], valid=1)]  # 2nd row is padding
    mean_cd = eval_pcn(c.cfg, c.model, batches)
    cd = c.metrics[0]
    assert abs(mean_cd - (2 * cd[0] + cd[1]) / 3) <= CD_GATE
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].split("\t") == ["Taxonomy", "#Samples", "cd", "dcd", "f1"]
    rows = {line.split("\t")[0]: line.split("\t") for line in lines[1:]}
    assert rows["a"][1] == "2" and rows["b"][1] == "1"
    assert abs(float(rows["b"][2]) - cd[1]) <= CD_GATE
    assert abs(float(rows["Overall"][2]) - mean_cd) <= 1e-4
