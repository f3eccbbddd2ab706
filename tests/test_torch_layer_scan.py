"""The layer scan's prefetch window (``ops/layer_scan``) against the JAX
package's.

- ``effective_window`` gives JAX's table.
- ``scan_layers`` in this process: a window of W layers under each remat
  mode gives W = 1's carry and gradients bit for bit, and a transform
  with ``issue`` is issued for the whole window before its first layer
  runs; with no transform the loop runs one layer to a checkpoint
  whatever ``prefetch_buffers`` says.
- On two gloo CPU ranks (``_torch_pipe_jobs.job_layer_scan``): the
  explicit full_shard step at fsdp 2 with ``prefetch_buffers`` 1, 2 and 3
  (windows 2, 2 and 4 over 4 layers) is bit-equal to prefetch 0 (loss,
  grad norm, params and moments) under ``names``, ``full`` and ``none``,
  with as many collectives; and held at JAX's tolerances to JAX's
  ``test_zero3_prefetch_bit_equivalent_to_jit_schedule`` setup (GPT-2
  n_embd 32, 4 layers, [2, 16, 16]): prefetch 0 to JAX's single-device
  step, prefetch 1 to JAX's explicit step at fsdp 2 with prefetch 1 (loss
  1e-5, grad norm and params 1e-4). At data 2 (no_shard), prefetch 1 is
  prefetch 0 and runs no window: there are no gathers to prefetch.
- ``generate_fsdp`` at prefetch 1 gives prefetch 0's tokens, greedy and
  sampled, and its monolithic loop's.
"""

import json
import threading

import jax
import numpy as np
import pytest
import torch

from _torch_dist_worker import launch
from _torch_pipe_cases import run_once
from test_torch_serving_tp import read_outputs
from test_torch_tp_train import _flatten, _save_npz
from pytorch_distributed_tpu.config import MeshConfig as JaxMeshConfig
from pytorch_distributed_tpu.config import ModelConfig as JaxModelConfig
from pytorch_distributed_tpu.config import TrainConfig as JaxTrainConfig
from pytorch_distributed_tpu.models import get_model as jget_model
from pytorch_distributed_tpu.ops.layer_scan import (
    effective_window as jeffective_window,
)
from pytorch_distributed_tpu.parallel import make_mesh, shard_train_state
from pytorch_distributed_tpu.parallel.explicit import (
    make_explicit_train_step,
)
from pytorch_distributed_tpu.parallel.mesh import make_batch_put
from pytorch_distributed_tpu.train.optim import make_optimizer as jmake_opt
from pytorch_distributed_tpu.train.state import init_train_state as jinit
from pytorch_distributed_tpu.train.trainer import make_train_step as jstep
from pytorch_distributed_tpu_torch import interop
from pytorch_distributed_tpu_torch.config import ModelConfig
from pytorch_distributed_tpu_torch.models import get_model
from pytorch_distributed_tpu_torch.ops.layer_scan import (
    effective_window,
    scan_layers,
)
from pytorch_distributed_tpu_torch.ops.remat import MODES

# JAX's test_prefetch.py setup.
MODEL = dict(vocab_size=128, n_ctx=16, n_embd=32, n_layer=4, n_head=4,
             dtype="float32", embd_pdrop=0.0, attn_pdrop=0.0,
             resid_pdrop=0.0, attention_impl="flash", remat="names")
TRAIN = dict(global_batch_size=32, micro_batch_size=16, num_steps=1,
             learning_rate=1e-3)
# prefetch_buffers 1-3 under names (windows 2, 2, 4), 1 under the others.
PREFETCH = {"names": [0, 1, 2, 3], "full": [0, 1], "none": [0, 1]}
CASES = [(remat, p) for remat, ps in PREFETCH.items() for p in ps[1:]]


def test_effective_window_is_jax():
    for n in range(1, 14):
        for p in range(-1, 15):
            assert effective_window(p, n) == jeffective_window(p, n), (p, n)


class _Issued:
    """A transform with ``issue``: records the order of issues and
    waits."""

    def __init__(self, log):
        self.log = log

    def __call__(self, bp):
        return self.issue(bp)()

    def issue(self, bp):
        self.log.append(("issue", bp["i"]))

        def wait():
            self.log.append(("wait", bp["i"]))
            return {"w": bp["w"] * 1.5, "i": bp["i"]}

        return wait


@pytest.mark.parametrize("mode", MODES)
def test_window_is_bit_equal_to_one_layer_at_a_time(mode):
    g = torch.Generator().manual_seed(0)
    ws = [torch.randn(8, 8, generator=g) for _ in range(6)]
    x0 = torch.randn(3, 8, generator=g)

    def run(prefetch):
        log = []
        live = [w.clone().requires_grad_() for w in ws]
        x = x0.clone().requires_grad_()
        blocks = [{"w": w, "i": i} for i, w in enumerate(live)]

        def block(c, bp, extra):
            y = torch.tanh(c[0] @ bp["w"]) + extra
            return y, c[1] + y.sum()

        out, tot = scan_layers(block, (x, x.sum() * 0), blocks,
                               [0.5 * i for i in range(6)], remat_mode=mode,
                               block_transform=_Issued(log),
                               prefetch_buffers=prefetch)
        (out.square().sum() + tot).backward()
        return out, tot, [w.grad for w in live], x.grad, log

    ref = run(0)
    for prefetch, window in ((1, 2), (2, 3), (5, 6)):
        got = run(prefetch)
        assert torch.equal(got[0], ref[0])
        assert torch.equal(got[1], ref[1])
        assert all(torch.equal(a, b) for a, b in zip(got[2], ref[2]))
        assert torch.equal(got[3], ref[3])
        # The forward's first window: every issue before the first wait.
        first = got[4][:2 * window]
        assert first == [("issue", i) for i in range(window)] + \
            [("wait", i) for i in range(window)]


def test_no_transform_runs_one_layer_to_a_checkpoint():
    """Nothing to prefetch: under ``full`` the backward replays the layers
    last to first, one checkpoint each, not a window's worth at once."""
    g = torch.Generator().manual_seed(1)
    live = [torch.randn(8, 8, generator=g).requires_grad_()
            for _ in range(4)]
    order = []

    def block(c, bp, extra):
        order.append(extra)
        return torch.tanh(c @ bp["w"])

    out = scan_layers(block, torch.randn(3, 8, generator=g),
                      [{"w": w} for w in live], list(range(4)),
                      remat_mode="full", prefetch_buffers=3)
    out.sum().backward()
    assert order == [0, 1, 2, 3, 3, 2, 1, 0]


def _jax_results(params, batch) -> dict:
    cfg = JaxModelConfig(**{k: v for k, v in MODEL.items()
                            if k not in ("attention_impl", "remat")})
    model = jget_model(cfg)
    out = {}
    tx = jmake_opt(JaxTrainConfig(**TRAIN))
    out["single"] = run_once(jstep(model, cfg, tx, donate=False),
                             jinit(params, tx), batch, jax.random.key(0))
    mcfg = JaxMeshConfig(fsdp=2, strategy="full_shard", prefetch_buffers=1)
    mesh = make_mesh(mcfg)
    state, _ = shard_train_state(jinit(params, tx), mesh, mcfg)
    step = make_explicit_train_step(model, cfg, tx, mesh, mcfg, state)
    out["prefetch1"] = run_once(step, state,
                                make_batch_put(mesh, mcfg)(batch),
                                jax.random.key(0))
    res = {}
    for k, (state, m) in out.items():
        flat: dict = {}
        _flatten("params", jax.device_get(state.params), flat)
        res[k] = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                      params=flat)
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory, eight_devices):
    wd = tmp_path_factory.mktemp("layer_scan")
    cfg = ModelConfig(**MODEL)
    params = interop.params_to_jax(get_model(cfg).init(
        torch.Generator().manual_seed(0), cfg, device="cpu"), cfg)
    _save_npz(wd / "params.npz", params)
    rng = np.random.default_rng(0)
    batch = dict(inputs=rng.integers(0, 128, (2, 16, 16)).astype(np.int32),
                 targets=rng.integers(0, 128, (2, 16, 16)).astype(np.int32))
    np.savez(wd / "batch.npz", **batch)
    (wd / "spec.json").write_text(json.dumps(dict(
        model=MODEL, train=TRAIN, prefetch=PREFETCH)))
    box: dict = {}
    th = threading.Thread(target=lambda: box.update(
        results=launch("layer_scan", 2, wd, timeout_s=240)))
    th.start()
    want = _jax_results(params, batch)
    th.join()
    assert "results" in box, "the port's ranks did not finish"
    return wd, want, read_outputs(wd, box["results"], n=2)


@pytest.mark.parametrize("remat, prefetch", CASES)
def test_zero3_prefetch_is_bit_equal_to_prefetch_0(runs, remat, prefetch):
    _, _, outs = runs
    for o in outs:
        base = o["steps"][f"{remat}/0"]
        got = o["steps"][f"{remat}/{prefetch}"]
        assert got == base, (remat, prefetch)
    assert outs[0]["steps"] == outs[1]["steps"]


def test_no_shard_prefetch_is_prefetch_0_with_no_window(runs):
    """At data 2 (no_shard) the explicit step has no gathers to prefetch:
    ``prefetch_buffers`` 1 runs prefetch 0's numbers and no window, while
    full_shard's prefetch 1 runs windows."""
    _, _, outs = runs
    for o in outs:
        assert o["steps"]["data/names/1"] == o["steps"]["data/names/0"]
        w = o["windowed"]
        assert (w["names/0"], w["names/1"]) == (False, True)
        assert (w["data/names/0"], w["data/names/1"]) == (False, False)


@pytest.mark.parametrize("prefetch, ref", [(0, "single"), (1, "prefetch1")])
def test_zero3_prefetch_matches_jax(runs, prefetch, ref):
    wd, want, outs = runs
    got = outs[0]["steps"][f"names/{prefetch}"]
    w = want[ref]
    assert got["loss"] == pytest.approx(w["loss"], abs=1e-5)
    assert got["grad_norm"] == pytest.approx(w["grad_norm"], abs=1e-4)
    with np.load(wd / f"params_pf{prefetch}.npz") as f:
        assert sorted(f.files) == sorted(w["params"])
        for k in f.files:
            np.testing.assert_allclose(f[k], np.asarray(w["params"][k]),
                                       atol=1e-4, err_msg=k)


@pytest.mark.parametrize("temp", [0.0, 0.8])
def test_generate_fsdp_prefetch_gives_prefetch_0_tokens(runs, temp):
    _, _, outs = runs
    for o in outs:
        g0, g1 = o["generate"][f"0/{temp}"], o["generate"][f"1/{temp}"]
        assert g1["tokens"] == g0["tokens"]
        assert g1["monolithic_equal"]
    assert outs[0]["generate"] == outs[1]["generate"]
