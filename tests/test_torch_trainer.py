"""PyTorch port vs JAX reference: the trainer, its checkpoints and launcher
(``train/trainer.py``, ``train/checkpointing.py``, ``launch/train.py``).

The model is the reference trainer tests' ``tiny_model()`` in float32 with
two microbatches. Both trainers start from one numpy parameter tree (the
JAX ``Trainer`` draws its own from ``jax.random``; the test replaces its
parameters and optimizer state). Whole-trainer runs are held by their
loss histories, at ``rtol = 1e-4``: AdamW's first steps turn gradient
elements near zero into ±lr moves, so post-step parameters of the two
frameworks are not compared element-wise (the update itself is held to the
reference on identical gradients in ``test_torch_optim.py``).

Checkpoints have the reference's layout and keys: a JAX-written one
restores into the port and continues beside the JAX continuation, a
port-written one restores through ``repro.train.checkpointing.restore``
and continues in the JAX trainer. Within the port a restarted run repeats
the straight one bit for bit, a SIGTERM leaves a synchronous commit, and
no ``.tmp`` directory survives a save. Weights the port trained serve
through the port's paged engine as through the synchronised JAX engine,
greedy stream for greedy stream.
"""

import dataclasses
import os
import signal
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.mesh import make_host_mesh
from repro.optim import optimizer as jopt
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import LLMEngine as JEngine
from repro.train import checkpointing as jckpt
from repro.train import trainer as jtrainer
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.launch import train as tlaunch
from repro_torch.models import registry as tregistry
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.models.schema import leaves
from repro_torch.optim import optimizer as topt
from repro_torch.serve import EngineConfig, LLMEngine
from repro_torch.train import checkpointing as tckpt
from repro_torch.train import trainer as ttrainer

from test_torch_serve import prompts_for, sync_reference_decode
from test_trainer import tiny_model

torch.set_num_threads(1)

RTOL = 1e-4


def configs(ckpt_dir=None, steps=40, **kw):
    """(JAX TrainConfig, port TrainConfig) of the reference tests'
    ``make_tc`` in float32."""
    jm = dataclasses.replace(tiny_model(), dtype="float32")
    tm = TModelConfig(**dataclasses.asdict(jm))
    oc = dict(lr=3e-3, warmup_steps=5, total_steps=steps)
    common = dict(global_batch=4, seq_len=32, microbatches=2,
                  ckpt_dir=None if ckpt_dir is None else str(ckpt_dir),
                  ckpt_every=10, ckpt_async=False)
    common.update(kw)
    return (jtrainer.TrainConfig(model=jm, opt=jopt.OptConfig(**oc),
                                 **common),
            ttrainer.TrainConfig(model=tm, opt=topt.OptConfig(**oc),
                                 **common))


def numpy_tree(tc):
    return bridge.numpy_params(tregistry.build(tc.model).schema(), seed=0)


def jax_trainer(jtc, npp):
    """The reference trainer, started from ``npp``."""
    t = jtrainer.Trainer(jtc, make_host_mesh())
    t.params = jax.tree.map(jnp.asarray, npp)
    t.opt_state = jopt.init(jtc.opt, t.params)
    return t


def port_trainer(ttc, npp=None):
    params = None if npp is None else bridge.params_from_numpy(npp, "cpu")
    return ttrainer.Trainer(ttc, device="cpu", params=params)


def losses(history):
    return np.asarray([h["loss"] for h in history])


def assert_trees_equal(a, b):
    fa, fb = tckpt.flatten_with_paths(a), tckpt.flatten_with_paths(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert torch.equal(fa[k], fb[k]), k


def test_loss_history_matches_the_jax_trainer():
    jtc, ttc = configs()
    npp = numpy_tree(ttc)
    want = losses(jax_trainer(jtc, npp).run(10, log_every=1))
    got = losses(port_trainer(ttc, npp).run(10, log_every=1))
    assert len(got) == len(want) == 10
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_loss_decreases_over_thirty_steps():
    _, ttc = configs()
    hist = port_trainer(ttc).run(30, log_every=5)
    assert [h["step"] for h in hist] == [5, 10, 15, 20, 25, 30]
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert all(np.isfinite(h["grad_norm"]) and h["sec"] > 0 for h in hist)


def test_checkpoint_restart_bit_identical(tmp_path):
    """Straight 8 steps vs 4 steps, a save, a fresh trainer restored, then
    4 more: every parameter and optimizer leaf equal bit for bit."""
    _, ttc = configs(tmp_path / "a")
    straight = port_trainer(ttc)
    straight.run(8, log_every=100)
    _, ttc = configs(tmp_path / "b")
    first = port_trainer(ttc)
    first.run(4, log_every=100)
    first.save(sync=True)
    again = port_trainer(ttc)
    assert again.restore_if_any() and again.step == 4
    again.run(8, log_every=100)
    assert_trees_equal(again.params, straight.params)
    assert_trees_equal(again.opt_state, straight.opt_state)


def test_jax_checkpoint_continues_in_the_port(tmp_path):
    jtc, ttc = configs(tmp_path)
    jt = jax_trainer(jtc, numpy_tree(ttc))
    jt.run(4, log_every=100)
    jt.save(sync=True)
    want = losses(jt.run(8, log_every=1))
    pt = port_trainer(ttc)
    assert pt.restore_if_any() and pt.step == 4
    assert tckpt.meta(str(tmp_path), 4)["arch"] == "lm-test"
    got = losses(pt.run(8, log_every=1))
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_port_checkpoint_restores_through_the_reference(tmp_path):
    jtc, ttc = configs(tmp_path)
    npp = numpy_tree(ttc)
    pt = port_trainer(ttc, npp)
    pt.run(3, log_every=100)
    pt.save(sync=True)
    jt = jax_trainer(jtc, npp)
    like = {"params": jax.device_get(jt.params),
            "opt": jax.device_get(jt.opt_state)}
    tree = jckpt.restore(str(tmp_path), 3, like)
    assert int(tree["opt"].step) == 3
    for mine, theirs in ((pt.params, tree["params"]),
                         (pt.opt_state, tree["opt"])):
        got = tckpt.flatten_with_paths(mine)
        want = jckpt._flatten_with_paths(theirs)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert jt.restore_if_any() and jt.step == 3
    want = losses(jt.run(6, log_every=1))
    got = losses(pt.run(6, log_every=1))
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_checkpoint_commit_is_atomic_and_round_trips(tmp_path):
    tree = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": [torch.ones(5, dtype=torch.int32),
                  torch.full((2,), 1.5, dtype=torch.bfloat16)],
            "opt": topt.AdamWState(torch.tensor(7, dtype=torch.int32),
                                   {"w": torch.zeros(2)}, {"w": torch.ones(2)})}
    tckpt.save(str(tmp_path), 3, tree, meta={"arch": "x"})
    thread = tckpt.save(str(tmp_path), 5, tree, async_write=True)
    thread.join(timeout=60)
    assert not thread.is_alive()
    names = sorted(p.name for p in Path(tmp_path).iterdir())
    assert names == ["step_00000003", "step_00000005"]
    assert tckpt.latest_step(str(tmp_path)) == 5
    assert tckpt.meta(str(tmp_path), 3) == {"step": 3, "arch": "x"}
    with np.load(tmp_path / "step_00000003" / "arrays.npz") as z:
        assert sorted(z.files) == ["a", "b/0", "b/1", "opt/m/w", "opt/step",
                                   "opt/v/w"]
    out = tckpt.restore(str(tmp_path), 3, tree, "cpu")
    assert isinstance(out["opt"], topt.AdamWState)
    assert out["b"][1].dtype == torch.bfloat16
    assert_trees_equal(out, tree)
    bad = {**tree, "a": torch.zeros(4, 3)}
    with pytest.raises(ValueError, match="shape mismatch at a"):
        tckpt.restore(str(tmp_path), 3, bad, "cpu")


def test_sigterm_mid_run_leaves_a_synchronous_commit(tmp_path):
    _, ttc = configs(tmp_path, ckpt_async=True, ckpt_every=1000)
    t = port_trainer(ttc)
    step_fn = t._step_fn

    def step_then_preempt(*args):
        out = step_fn(*args)
        if t.step == 2:  # during the third step
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    t._step_fn = step_then_preempt
    old = signal.getsignal(signal.SIGTERM)
    try:
        t.install_preemption_handler()
        t.run(10, log_every=100)
    finally:
        signal.signal(signal.SIGTERM, old)
    assert t.step == 3
    assert tckpt.latest_step(str(tmp_path)) == 3
    back = tckpt.restore(str(tmp_path), 3, {"params": t.params}, "cpu")
    assert_trees_equal(back["params"], t.params)


@pytest.mark.parametrize("entry", ["trainer", "train_step", "launcher"])
def test_dp_compress_is_refused_by_name(entry):
    _, ttc = configs(dp_compress=True)
    with pytest.raises(NotImplementedError, match="dp_compress"):
        if entry == "trainer":
            port_trainer(ttc)
        elif entry == "train_step":
            ttrainer.make_train_step(tregistry.build(ttc.model), ttc)
        else:
            tlaunch.main(["--arch", "phi3-mini-3.8b", "--smoke", "--device",
                          "cpu", "--dp-compress"])


def test_launcher_trains_and_resumes_on_the_cpu(tmp_path, capsys):
    argv = ["--arch", "phi3-mini-3.8b", "--smoke", "--device", "cpu",
            "--global-batch", "4", "--seq", "16", "--microbatches", "2",
            "--ckpt-dir", str(tmp_path)]
    tlaunch.main(argv + ["--steps", "10"])
    out = capsys.readouterr().out
    assert "step     10 loss" in out
    # the trainer checkpoints every 100 steps; commit one to resume from
    tc = ttrainer.TrainConfig(model=tconfigs.smoke_config("phi3-mini-3.8b"),
                              opt=topt.OptConfig(), ckpt_dir=str(tmp_path))
    t = ttrainer.Trainer(tc, device="cpu")
    t.step = 10
    t.save(sync=True)
    tlaunch.main(argv + ["--steps", "20", "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 10" in out and "step     20 loss" in out


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_states_bridge_both_ways(name):
    rng = np.random.default_rng(0)
    params = {"w": jnp.asarray(rng.standard_normal((4, 3)), jnp.float32),
              "s": [{"v": jnp.asarray(rng.standard_normal((2, 3, 3)),
                                      jnp.float32)}]}
    oc = jopt.OptConfig(name=name)
    grads = jax.tree.map(jnp.ones_like, params)
    _, state, _ = jopt.update(oc, jopt.init(oc, params), params, grads)
    np_state = jax.device_get(state)
    port = bridge.opt_state_from_numpy(np_state, "cpu")
    assert type(port).__name__ == type(state).__name__
    assert port.step.dtype == torch.int32 and int(port.step) == 1
    back = bridge.numpy_from_opt_state(port)
    for a, b in zip(jax.tree.leaves(tuple(np_state)),
                    leaves(list(back))):
        np.testing.assert_array_equal(a, b)


def test_trained_port_weights_serve_like_the_jax_engine():
    """A few port training steps on glm4-9b-smoke (float32), then the
    trained weights through both packages' paged engines: greedy streams
    equal, request for request."""
    model = dataclasses.replace(tconfigs.smoke_config("glm4-9b"),
                                dtype="float32", serve_quant=False)
    tc = ttrainer.TrainConfig(model=model, opt=topt.OptConfig(
        lr=1e-2, warmup_steps=1, total_steps=4), global_batch=4, seq_len=16)
    t = ttrainer.Trainer(tc, device="cpu")
    before = bridge.numpy_from_params(t.params)
    t.run(4, log_every=100)
    npp = bridge.numpy_from_params(t.params)
    assert not np.array_equal(npp["embed"], before["embed"])
    from repro import configs as jconfigs
    from repro.models import registry as jregistry

    jarch = jregistry.build(dataclasses.replace(
        jconfigs.smoke_config("glm4-9b"), dtype="float32",
        serve_quant=False))
    kw = dict(slots=4, max_len=64, admit_window=2, scheduler="bounded")
    je = sync_reference_decode(JEngine(
        jarch, jax.tree.map(jnp.asarray, npp),
        JEngineConfig(backend="paged", attn_backend="xla", **kw)))
    te = LLMEngine(tregistry.build(model), bridge.params_from_numpy(npp, "cpu"),
                   EngineConfig(backend="paged", **kw), device="cpu")
    prompts = prompts_for(model.vocab)
    jh = [je.add_request(p, max_new_tokens=8) for p in prompts]
    th = [te.add_request(p, max_new_tokens=8) for p in prompts]
    je.run_until_drained()
    te.run_until_drained()
    assert ([te.request(h).output for h in th]
            == [je.request(h).output for h in jh])
