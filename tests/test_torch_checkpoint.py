"""Checkpoints of the port: whole-learner round trips and JAX bundles
carried across.

The port's versions of ``tests/test_checkpoint.py:32-106``: a killed and
restored DQN learner continues bit-exactly, saves come every
``save_interval`` and are pruned to ``keep``, evaluation from a file needs
no trainer, the config meta round-trips, a crash mid-save leaves the
previous checkpoint restorable, and the loader refuses pickled objects.
Then an ``ApexTrainer`` round trip and its saves from ``train()``, and an
``AQLApexTrainer`` on pixels (two Adam groups, the frame pool's ``a_mu``
sidecar) whose round trip continues bit-exactly and whose file
``evaluate_checkpoint`` scores.  JAX bundles carried across are
``tests/test_torch_convert.py``.
"""

import copy
import dataclasses
import pickle

import numpy as np
import pytest
import torch

from apex_tpu.config import small_test_config as jax_small_config
from apex_tpu_torch.config import (ActorConfig, ApexConfig, EnvConfig,
                                   LearnerConfig, ReplayConfig,
                                   small_test_config)
from apex_tpu_torch.replay.frame_chunks import (FrameChunkBuilder,
                                                drain_builder_chunks)
from apex_tpu_torch.training import checkpoint as ckpt
from apex_tpu_torch.training.apex import ApexTrainer
from apex_tpu_torch.training.dqn import DQNTrainer


@pytest.fixture(autouse=True)
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _cfg(**learner):
    cfg = small_test_config(capacity=256, batch_size=16, n_actors=1)
    return cfg.replace(learner=dataclasses.replace(cfg.learner, **learner))


def _assert_learners_equal(a, b):
    for mod_a, mod_b in ((a.train_state.params, b.train_state.params),
                         (a.train_state.target_params,
                          b.train_state.target_params)):
        for (name, x), y in zip(mod_a.state_dict().items(),
                                mod_b.state_dict().values(), strict=True):
            assert torch.equal(x, y), name
    oa, ob = a.train_state.opt_state, b.train_state.opt_state
    assert oa.count == ob.count and a.train_state.step == b.train_state.step
    for x, y in zip(oa.mu + oa.nu, ob.mu + ob.nu, strict=True):
        assert torch.equal(x, y)
    ra, rb = a.replay_state, b.replay_state
    for f in dataclasses.fields(ra):
        x, y = getattr(ra, f.name), getattr(rb, f.name)
        if isinstance(x, dict):
            assert x.keys() == y.keys()
            assert all(torch.equal(x[k], y[k]) for k in x), f.name
        elif isinstance(x, torch.Tensor):
            assert torch.equal(x, y), f.name
        else:
            assert x == y, f.name
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_kill_restore_resume_is_bit_exact(tmp_path):
    t1 = DQNTrainer(_cfg(), checkpoint_dir=str(tmp_path / "ck"),
                    device="cpu")
    t1.train(total_frames=300)          # past the warm-up: it trained
    assert t1.steps_rate.total > 0
    path = t1.save_checkpoint()

    t2 = DQNTrainer(_cfg(), checkpoint_dir=str(tmp_path / "ck2"),
                    device="cpu")
    t2.restore(path)                    # the new process after a kill
    assert t2.steps_rate.total == t1.steps_rate.total
    assert (t2.ingested, t2.frames_rate.total) == (t1.ingested, 300)
    _assert_learners_equal(t1, t2)
    for tr in (t1, t2):                 # the learner alone continues
        for _ in range(5):
            tr.train_step(0.5)
    _assert_learners_equal(t1, t2)


def test_autosave_every_save_interval(tmp_path):
    t = DQNTrainer(_cfg(save_interval=50), checkpoint_dir=str(tmp_path),
                   device="cpu")
    t.train(total_frames=200)
    assert t.steps_rate.total >= 100
    path = t.checkpointer.latest_path()
    _, meta = ckpt.load_raw(path)
    assert meta["steps"] % 50 == 0 and meta["steps"] > 0
    assert path.endswith(f"ckpt_{meta['steps']}.pt")


def test_evaluate_checkpoint_without_trainer_equals_trainer_evaluate(
        tmp_path):
    cfg = _cfg()
    t = DQNTrainer(cfg, checkpoint_dir=str(tmp_path), device="cpu")
    t.train(total_frames=200)
    path = t.save_checkpoint()
    want = t.evaluate(episodes=2, max_steps=100)
    del t                               # nothing of the trainer survives
    score = ckpt.evaluate_checkpoint(path, episodes=2, max_steps=100,
                                     seed=cfg.env.seed + 1000, device="cpu")
    assert np.isfinite(score) and score > 0   # CartPole pays 1 per step
    assert score == want


def test_checkpointer_prunes_to_keep(tmp_path):
    ck = ckpt.Checkpointer(str(tmp_path), keep=3)
    for step in (10, 20, 30, 40):
        ck.save(step, dict(x=torch.arange(4), n=step), dict(step=step))
    names = sorted(p.name for p in tmp_path.glob("ckpt_*"))
    assert names == ["ckpt_20.pt", "ckpt_30.pt", "ckpt_40.pt"]
    assert ck.latest_path().endswith("ckpt_40.pt")
    state, meta = ckpt.load_raw(ck.latest_path())
    assert state["n"] == 40 and meta == {"step": 40}
    assert torch.equal(state["x"], torch.arange(4))


def test_config_meta_roundtrip():
    cfg = small_test_config(capacity=512, batch_size=64, n_actors=4)
    assert ckpt.config_from_meta(ckpt.config_to_meta(cfg)) == cfg
    # a JAX config's meta rebuilds the sections the port has
    jax_meta = dataclasses.asdict(jax_small_config(capacity=512,
                                                   batch_size=64, n_actors=4))
    assert ckpt.config_from_meta(jax_meta) == cfg


def test_crash_mid_save_leaves_the_previous_checkpoint_restorable(
        tmp_path, monkeypatch):
    t = DQNTrainer(_cfg(), checkpoint_dir=str(tmp_path), device="cpu")
    t.train(total_frames=150)
    good = t.save_checkpoint()
    t.train(total_frames=20)

    def torn_write(obj, path):
        with open(path, "wb") as f:
            f.write(b"half a checkpoint")
        raise OSError("disk full")

    monkeypatch.setattr(ckpt.torch, "save", torn_write)
    with pytest.raises(OSError, match="disk full"):
        t.save_checkpoint()
    monkeypatch.undo()
    assert t.checkpointer.latest_path() == good
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        good.rsplit("/", 1)[1]]
    fresh = DQNTrainer(_cfg(), checkpoint_dir=str(tmp_path), device="cpu")
    fresh.restore()
    assert fresh.frames_rate.total == 150


class _Payload:
    def __reduce__(self):
        return (print, ("code ran at load time",))


def test_load_refuses_pickled_objects(tmp_path):
    path = str(tmp_path / "ckpt_1.pt")
    torch.save({"state": {"x": _Payload()}, "meta": "{}"}, path)
    with pytest.raises(pickle.UnpicklingError):
        ckpt.load_raw(path)


def test_restore_refuses_a_mismatched_bundle(tmp_path):
    a = DQNTrainer(_cfg(), checkpoint_dir=str(tmp_path / "a"), device="cpu")
    path = a.save_checkpoint()
    b = DQNTrainer(dataclasses.replace(
        _cfg(), replay=dataclasses.replace(_cfg().replay, capacity=512)),
        device="cpu")
    with pytest.raises(ValueError, match="obs: .* does not fit"):
        b.restore(path)


# -- ApexTrainer -----------------------------------------------------------

ENV, B, K = "ApexCatchSmall-v0", 16, 16


class StubPool:
    def __init__(self, msgs=()):
        self._msgs = list(msgs)
        self.procs = []

    def start(self):
        pass

    def cleanup(self):
        pass

    def publish_params(self, version, params):
        pass

    def poll_stats(self):
        return []

    def poll_chunks(self, max_chunks, timeout=0.0):
        out, self._msgs = self._msgs[:max_chunks], self._msgs[max_chunks:]
        return out


def _catch_messages(n):
    rng = np.random.default_rng(0)
    b = FrameChunkBuilder(3, 0.99, 4, (42, 42, 1), chunk_transitions=K)
    msgs = []
    while len(msgs) < n:
        b.begin_episode(rng.integers(0, 255, (42, 42, 1)).astype(np.uint8))
        length = int(rng.integers(5, 40))
        for t in range(length):
            b.add_step(int(rng.integers(0, 3)), float(rng.normal()),
                       rng.normal(size=3).astype(np.float32),
                       rng.integers(0, 255, (42, 42, 1)).astype(np.uint8),
                       t == length - 1, False)
        msgs.extend(drain_builder_chunks(b))
    return msgs[:n]


def _apex_cfg():
    return ApexConfig(
        env=EnvConfig(env_id=ENV, seed=5),
        replay=ReplayConfig(capacity=512, warmup=64),
        learner=LearnerConfig(batch_size=B, compute_dtype="float32",
                              target_update_interval=7),
        actor=ActorConfig(send_interval=K))


def test_apex_trainer_roundtrip_continues_bit_exactly(tmp_path):
    msgs = _catch_messages(12)
    t1 = ApexTrainer(_apex_cfg(), pool=StubPool(), device="cpu",
                     checkpoint_dir=str(tmp_path))
    for msg in copy.deepcopy(msgs[:8]):
        t1.consume([msg])
    saved_steps = t1.steps
    assert saved_steps > 0
    path = t1.save_checkpoint()
    assert path.endswith(f"ckpt_{saved_steps}.pt")
    t2 = ApexTrainer(_apex_cfg(), pool=StubPool(), device="cpu")
    t2.restore(path)
    assert (t2.steps, t2.ingested, t2.param_version) == (
        t1.steps, t1.ingested, t1.param_version)
    assert t2.learner_epoch == t1.learner_epoch + 1
    _assert_learners_equal(t1, t2)
    for tr in (t1, t2):
        for msg in copy.deepcopy(msgs[8:]):
            tr.consume([msg])
    assert t1.steps == t2.steps == saved_steps + 4
    _assert_learners_equal(t1, t2)


def test_apex_trainer_saves_every_save_interval_in_train(tmp_path):
    cfg = _apex_cfg()
    cfg = cfg.replace(learner=dataclasses.replace(cfg.learner,
                                                  save_interval=4))
    t = ApexTrainer(cfg, pool=StubPool(_catch_messages(16)), device="cpu",
                    publish_min_seconds=0.0, respawn_workers=False,
                    checkpoint_dir=str(tmp_path))
    t.train(total_steps=10, max_seconds=60, log_every=10 ** 9)
    steps = sorted(ckpt.Checkpointer._step_of(p.name)
                   for p in tmp_path.glob("ckpt_*.pt"))
    assert steps == [4, 8]
    _, meta = ckpt.load_raw(str(tmp_path / "ckpt_8.pt"))
    assert meta["learner_epoch"] == 1 and meta["param_version"] >= 1
    assert meta["model_spec"]["obs_shape"] == [42, 42, 4]


def _aql_pixel_messages(n, t):
    """Pixel AQL chunk messages: Catch-sized frames with an ``a_mu``
    sidecar of ``t`` discrete candidates."""
    rng = np.random.default_rng(1)
    b = FrameChunkBuilder(1, 0.99, 4, (42, 42, 1), chunk_transitions=K,
                          extra_shapes={"a_mu": (t, 1)})
    msgs = []
    while len(msgs) < n:
        b.begin_episode(rng.integers(0, 255, (42, 42, 1)).astype(np.uint8))
        length = int(rng.integers(5, 40))
        for i in range(length):
            b.add_step(int(rng.integers(0, t)), float(rng.normal()),
                       rng.normal(size=t).astype(np.float32),
                       rng.integers(0, 255, (42, 42, 1)).astype(np.uint8),
                       i == length - 1, False,
                       extras={"a_mu": rng.integers(0, 3, (t, 1)).astype(
                           np.float32)})
        msgs.extend(drain_builder_chunks(b))
    return msgs[:n]


def test_aql_apex_trainer_roundtrip_continues_bit_exactly(tmp_path):
    from apex_tpu_torch.training.aql import AQLApexTrainer
    from tests.test_torch_aql import assert_aql_learners_equal

    cfg = _apex_cfg()
    cfg = cfg.replace(aql=dataclasses.replace(cfg.aql, propose_sample=5,
                                              uniform_sample=8))
    msgs = _aql_pixel_messages(12, 5 + 3)           # uniform clamped to 3
    t1 = AQLApexTrainer(cfg, pool=StubPool(), device="cpu",
                        checkpoint_dir=str(tmp_path))
    for msg in copy.deepcopy(msgs[:8]):
        t1.consume([msg])
    assert t1.steps > 0
    path = t1.save_checkpoint()
    _, meta = ckpt.load_raw(path)
    assert meta["model_spec"]["discrete"] is True
    assert meta["config"]["aql"]["propose_sample"] == 5
    t2 = AQLApexTrainer(cfg, pool=StubPool(), device="cpu")
    t2.restore(path)
    assert (t2.steps, t2.ingested) == (t1.steps, t1.ingested)
    assert bool(t2.replay_state.extras["a_mu"].abs().sum() > 0)
    assert_aql_learners_equal(t1, t2)
    for tr in (t1, t2):
        for msg in copy.deepcopy(msgs[8:]):
            tr.consume([msg])
    assert t1.steps == t2.steps
    assert_aql_learners_equal(t1, t2)
    # evaluation from the file alone: mu-only heads on the stacked env
    score = ckpt.evaluate_checkpoint(path, episodes=1, max_steps=200,
                                     device="cpu")
    assert np.isfinite(score) and -5.0 <= score <= 5.0
