"""The port's checkpoints and gradient accumulation on the CPU: an exact
round trip of the whole train state, ``--which_epoch`` resolution, pruning,
the fail-fast partial restore, the cursor, asynchronous saves, the
resume trajectory (k steps, save, restore, N-k steps against N steps, bit
for bit, with and without the ``niter_fix_global`` unfreeze between, and in
the middle of an update across it), and ``accum_steps`` against the JAX
package's ``optax.MultiSteps``.

Sizes: the small LocalEnhancer and discriminator of ``test_torch_train.py``
on a (32, 64) spectrum, batch 4 (2 a micro-batch).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mdctgan_tpu.train import schedule as jschedule
from mdctgan_tpu.train.state import GANTrainState as JGANTrainState
from mdctgan_tpu.train.step import build_train_step as j_build_train_step

from mdctgan_tpu_torch.models.generator import LocalEnhancer
from mdctgan_tpu_torch.train import checkpoint, freeze, schedule
from mdctgan_tpu_torch.train.checkpoint import CheckpointManager, state_digest
from mdctgan_tpu_torch.weights import state_dict_from_jax

from test_torch_models import SMALL_LOCAL
from test_torch_train import ADAM, D_CFG, SGD, _batch, _port_state, _port_step, env  # noqa: F401


def _adam(accum_steps=1):
    return schedule.make_optimizers(ADAM["lr"], ADAM["beta1"], ADAM["niter"],
                                    ADAM["niter_decay"], ADAM["steps_per_epoch"],
                                    accum_steps=accum_steps)


def _trained(env, steps=1, g_tx=None, d_tx=None):
    """A port train state after ``steps`` Adam steps, with its step function."""
    if g_tx is None:
        g_tx, d_tx = _adam()
    state = _port_state(env, g_tx, d_tx)
    step = _port_step(env, g_tx, d_tx)
    for _ in range(steps):
        step(state, _batch(env))
    return state, step


def _assert_states_equal(a, b):
    """Every tensor of G, D and both optimizers, their parameter names and
    the step, bit for bit."""
    assert state_digest(a) == state_digest(b)
    for ma, mb in ((a.generator, b.generator), (a.discriminator, b.discriminator)):
        sa, sb = ma.state_dict(), mb.state_dict()
        assert sa.keys() == sb.keys()
        assert all(torch.equal(sa[k], sb[k]) for k in sa)


# --------------------------------------------------------------------------
# the manager
# --------------------------------------------------------------------------

def test_round_trip_is_exact(env, tmp_path):
    state, _ = _trained(env, 2)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(state, epoch=3, epoch_iter=8)
    fresh = _port_state(env, *_adam())
    assert state_digest(fresh) != state_digest(state)
    got, epoch, it = mgr.restore(fresh)
    assert got is fresh and (epoch, it) == (3, 8) and fresh.step == 2
    _assert_states_equal(fresh, state)
    assert checkpoint.is_port_checkpoint(str(tmp_path / "ckpt"))
    assert not checkpoint.is_port_checkpoint(str(tmp_path))
    mgr.close()


def test_resolve_epoch(env, tmp_path):
    """``latest``, an epoch number, a missing epoch, a word, and a stale
    index entry whose save is gone, each as the JAX manager answers."""
    state, step = _trained(env, 1)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(state, epoch=2, epoch_iter=0, epoch_label=1)
    step(state, _batch(env))
    mgr.save(state, epoch=3, epoch_iter=0, epoch_label=2)
    assert mgr.resolve_epoch("latest") == mgr.resolve_epoch(None) == 2
    assert mgr.resolve_epoch(1) == mgr.resolve_epoch("1") == 1
    with pytest.raises(FileNotFoundError, match=r"available epochs: \[1, 2\]"):
        mgr.resolve_epoch(7)
    with pytest.raises(FileNotFoundError, match="neither 'latest' nor"):
        mgr.resolve_epoch("best")
    mgr.close()
    # a fresh manager reads the index from disk, as the inference entry
    # points do
    again = CheckpointManager(str(tmp_path / "ckpt"))
    assert again.resolve_epoch(2) == 2
    (tmp_path / "ckpt" / "step_1.pt").unlink()
    with pytest.raises(FileNotFoundError, match="does not exist"):
        again.resolve_epoch(1)


def test_pruning_keeps_epoch_end_saves(env, tmp_path):
    state, step = _trained(env, 1)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    for i in range(6):
        mgr.save(state, epoch=1, epoch_iter=4 * i, epoch_label=1 if state.step == 2 else None)
        step(state, _batch(env))
    mgr.wait()
    assert mgr.all_steps() == [2, 5, 6]
    assert [s["step"] for s in mgr.saves] == [1, 2, 3, 4, 5, 6]
    assert all(s["bytes"] > 0 and s["write_ms"] > 0 and s["snapshot_ms"] > 0
               for s in mgr.saves)


def test_restore_fields_names_a_mismatched_architecture(env, tmp_path):
    state, _ = _trained(env, 1)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(state, epoch=1)
    template = state.generator.state_dict()
    got = mgr.restore_fields({"generator": template})["generator"]
    assert got.keys() == template.keys()
    assert all(torch.equal(got[k], template[k]) for k in template)
    other = dict(template)
    other["phantom_block.conv.bias"] = torch.zeros(7)
    name = next(k for k in template if k.endswith("weight"))
    other[name] = torch.zeros(3, 3)
    with pytest.raises(ValueError, match=r"2 requested.*phantom_block.*missing.*opt\.txt"):
        mgr.restore_fields({"generator": other})
    with pytest.raises(ValueError, match=f"{name} \\(saved"):
        mgr.restore_fields({"generator": other})


def test_peek_cursor(env, tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.peek_cursor() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(_port_state(env, *_adam()))
    state, step = _trained(env, 1)
    mgr.save(state, epoch=4, epoch_iter=12)
    step(state, _batch(env))
    mgr.save(state, epoch=5, epoch_iter=0)
    assert mgr.peek_cursor() == (5, 0)
    assert mgr.peek_cursor(step=1) == (4, 12)


def test_legacy_cursor_counts_batches(env, tmp_path):
    """A cursor without ``units_samples`` counted batches: restore converts
    it with the batch size; a current one passes unchanged."""
    state, _ = _trained(env, 1)
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    torch.save({"format": checkpoint.FORMAT, "state": checkpoint.snapshot(state),
                "cursor": {"epoch": 2, "epoch_iter": 7}}, ckpt / "step_1.pt")
    _, epoch, it = CheckpointManager(str(ckpt)).restore(_port_state(env, *_adam()),
                                                        batch_size=20)
    assert (epoch, it) == (2, 140)
    mgr = CheckpointManager(str(tmp_path / "ckpt2"))
    mgr.save(state, epoch=3, epoch_iter=60)
    assert mgr.restore(_port_state(env, *_adam()), batch_size=20)[1:] == (3, 60)


def test_async_save_is_not_changed_by_a_later_step(env, tmp_path, monkeypatch):
    """The save copies the state when called: a step taken while the write
    is in flight (held back here until the step is done) moves the live
    parameters and Adam moments in place, and must not reach the file."""
    state, step = _trained(env, 1)
    before = state_digest(state)
    gate, real_save = threading.Event(), torch.save

    def held_save(*args, **kwargs):
        assert gate.wait(timeout=60)
        real_save(*args, **kwargs)

    monkeypatch.setattr(torch, "save", held_save)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(state, epoch=1, epoch_iter=4)
    step(state, _batch(env))
    assert state_digest(state) != before and not mgr.saves
    gate.set()
    fresh = _port_state(env, *_adam())
    mgr.restore(fresh)  # waits for the write
    assert state_digest(fresh) == before
    mgr.close()


def test_restore_refuses_another_optimizer_mask(env, tmp_path):
    """Adam's state is indexed by position: a save of the masked optimizer
    (``niter_fix_global``) restored into the unmasked one is refused by
    name, never loaded onto the wrong tensors."""
    names = [n for n, _ in LocalEnhancer(**SMALL_LOCAL).named_parameters()]
    g_tx, d_tx = _adam()
    masked = freeze.masked_optimizer(g_tx, freeze.param_labels(names, fix_global=True))
    state, _ = _trained(env, 1, masked, d_tx)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(state, epoch=1)
    with pytest.raises(ValueError, match=r"g_opt was saved over \d+ parameters.*trained only"):
        mgr.restore(_port_state(env, g_tx, d_tx))
    fresh = _port_state(env, masked, d_tx)
    mgr.restore(fresh)
    _assert_states_equal(fresh, state)


def test_a_step_already_saved_is_not_written_again(env, tmp_path):
    """As orbax does: a save at a step that is not newer than the latest
    keeps the save already there; an epoch label still points at it."""
    state, _ = _trained(env, 1)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(state, epoch=1, epoch_iter=4)
    mgr.save(state, epoch=2, epoch_iter=0, epoch_label=1)
    assert mgr.peek_cursor() == (1, 4)
    assert mgr.resolve_epoch(1) == 1 and len(mgr.saves) == 1


# --------------------------------------------------------------------------
# the resume trajectory
# --------------------------------------------------------------------------

@pytest.mark.parametrize("unfreeze", [False, True])
def test_resume_trajectory_is_bitwise(env, tmp_path, unfreeze):
    """k = 2 steps, save, restore into a freshly built state, N - k = 2
    steps: the same losses, weights, BatchNorm statistics, Adam moments and
    step as N = 4 steps without a break, bit for bit.  With ``unfreeze``
    the first k steps train only the enhancer branch, and the unfreeze (a
    fresh unmasked G optimizer, the schedule's count kept) comes between,
    before the save, as the train CLI orders it."""
    names = [n for n, _ in LocalEnhancer(**SMALL_LOCAL).named_parameters()]
    g_tx, d_tx = _adam()
    first_tx = (freeze.masked_optimizer(g_tx, freeze.param_labels(names, fix_global=True))
                if unfreeze else g_tx)
    batches = [_batch(env)] * 4

    def run(state, step, todo):
        return [{k: v.clone() for k, v in step(state, b)[1].items()} for b in todo]

    whole = _port_state(env, first_tx, d_tx)
    losses = run(whole, _port_step(env, first_tx, d_tx), batches[:2])
    if unfreeze:
        whole = schedule.carry_schedule_count(whole, g_tx)
    losses += run(whole, _port_step(env, g_tx, d_tx), batches[2:])

    part = _port_state(env, first_tx, d_tx)
    resumed = run(part, _port_step(env, first_tx, d_tx), batches[:2])
    if unfreeze:
        part = schedule.carry_schedule_count(part, g_tx)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(part, epoch=2, epoch_iter=0, epoch_label=1)
    mgr.close()
    fresh = _port_state(env, g_tx, d_tx)
    CheckpointManager(str(tmp_path / "ckpt")).restore(fresh)
    _assert_states_equal(fresh, part)
    resumed += run(fresh, _port_step(env, g_tx, d_tx), batches[2:])

    assert fresh.step == whole.step == 4
    for a, b in zip(losses, resumed):
        assert all(torch.equal(a[k], b[k]) for k in a)
    _assert_states_equal(fresh, whole)


def test_accumulation_resumes_mid_update_bitwise(env, tmp_path):
    """A save between two micro-batches of one update keeps the running
    gradient mean, so the update after the restore is the uninterrupted
    one."""
    g_tx, d_tx = _adam(accum_steps=2)
    halves = [_batch(env)] * 3
    whole, step = _trained(env, 0, g_tx, d_tx)
    for b in halves:
        step(whole, b)
    part, step = _trained(env, 0, g_tx, d_tx)
    step(part, halves[0])
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(part, epoch=1, epoch_iter=4, accum_steps=2)
    fresh = _port_state(env, g_tx, d_tx)
    mgr.restore(fresh)
    assert all(p.grad is not None for p in fresh.generator.parameters())
    for b in halves[1:]:
        step(fresh, b)
    _assert_states_equal(fresh, whole)


def test_accumulation_resumes_mid_update_across_the_unfreeze_bitwise(env, tmp_path):
    """k = 4, the unfreeze after 6 micro-steps (half way through D's second
    update): G's window starts afresh there.  A save one micro-step later,
    in the middle of both nets' updates (G 1 of 4, D 3 of 4), restored into
    a freshly built state, then 5 more micro-steps: the same state as 12
    micro-steps without a break, bit for bit, with G's window start and
    both nets' partial gradients carried by the save."""
    names = [n for n, _ in LocalEnhancer(**SMALL_LOCAL).named_parameters()]
    g_tx, d_tx = _adam(accum_steps=4)
    first_tx = freeze.masked_optimizer(g_tx, freeze.param_labels(names, fix_global=True))
    halves = [{n: v[2 * i: 2 * i + 2] for n, v in _batch(env).items()} for i in range(2)]
    batches = [halves[i % 2] for i in range(12)]

    def start():
        state = _port_state(env, first_tx, d_tx)
        step = _port_step(env, first_tx, d_tx)
        for b in batches[:6]:
            step(state, b)
        return schedule.carry_schedule_count(state, g_tx)

    whole = start()
    assert whole.g_window_start == 6 and all(p.grad is None for p in whole.generator.parameters())
    step = _port_step(env, g_tx, d_tx)
    for b in batches[6:]:
        step(whole, b)

    part = start()
    step(part, batches[6])
    assert (part.micro_index("G", 4), part.micro_index("D", 4)) == (1, 3)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(part, epoch=4, epoch_iter=2, accum_steps=4)
    fresh = _port_state(env, g_tx, d_tx)
    mgr.restore(fresh)
    assert fresh.g_window_start == 6 and fresh.step == 7
    assert all(p.grad is not None for p in [*fresh.generator.parameters(),
                                            *fresh.discriminator.parameters()])
    for b in batches[7:]:
        step(fresh, b)
    _assert_states_equal(fresh, whole)
    assert fresh.update_count("G", 4) == 2 and fresh.update_count("D", 4) == 3


# --------------------------------------------------------------------------
# gradient accumulation against optax.MultiSteps
# --------------------------------------------------------------------------

def test_gradient_accumulation_matches_jax_multisteps(env):
    """k = 2 micro-batches an update (rows 0-1, then rows 2-3), 2k + 2 = 6
    micro-steps: the parameters move only on every k-th, the schedule
    counts updates (2e-4, 2e-4, then 1e-4 in the third epoch of one
    update each), and after each update G and D are within
    ``test_adam_trajectory_matches_jax``'s bounds of JAX's MultiSteps(Adam):
    RMS 0.05 lr for every tensor whose gradient is not f32 dust, 2.5 lr
    times (updates + 1) at its largest."""
    k, micro = 2, 6
    lr = ADAM["lr"]
    spe = 2  # micro-steps an epoch: one update each
    halves = [{n: v[2 * i: 2 * i + 2] for n, v in _batch(env).items()} for i in range(2)]

    j_g, j_d = jschedule.make_optimizers(lr, ADAM["beta1"], ADAM["niter"], ADAM["niter_decay"],
                                         spe, accum_steps=k)
    j_step = j_build_train_step(env["flax_g"], env["flax_d"], env["jt"], j_g, j_d,
                                n_layers_d=D_CFG["n_layers"], num_d=D_CFG["num_D"],
                                donate=False)
    j_state = JGANTrainState(
        step=jnp.zeros((), jnp.int32), g_params=env["g_params"], d_params=env["d_params"],
        batch_stats=env["g_stats"], g_opt_state=j_g.init(env["g_params"]),
        d_opt_state=j_d.init(env["d_params"]))
    ref = []
    for i in range(micro):
        b = {n: jnp.asarray(v.numpy()) for n, v in halves[i % 2].items()}
        j_state, _ = j_step(j_state, b, jax.random.PRNGKey(1))
        ref.append(jax.device_get((j_state.g_params, j_state.d_params)))

    # tensors whose true gradient is zero hold f32 dust on both sides, and
    # Adam moves them by ~lr in any direction
    sgd_state = _port_state(env)
    before = {n: p.detach().clone() for n, p in sgd_state.generator.named_parameters()}
    before.update({n: p.detach().clone() for n, p in sgd_state.discriminator.named_parameters()})
    _port_step(env)(sgd_state, halves[0])
    after = dict(sgd_state.generator.named_parameters())
    after.update(dict(sgd_state.discriminator.named_parameters()))
    dust = {n: float((before[n] - after[n].detach()).pow(2).mean().sqrt()) < 1e-5 for n in before}

    g_tx, d_tx = schedule.make_optimizers(lr, ADAM["beta1"], ADAM["niter"], ADAM["niter_decay"],
                                          spe, accum_steps=k)
    assert g_tx.accum_steps == d_tx.accum_steps == k
    state = _port_state(env, g_tx, d_tx)
    step = _port_step(env, g_tx, d_tx)
    lrs = []
    for i in range(micro):
        prev = {n: p.detach().clone() for n, p in state.generator.named_parameters()}
        step(state, halves[i % 2])
        moved = any(not torch.equal(prev[n], p) for n, p in state.generator.named_parameters())
        assert moved == (i % k == k - 1), i
        if not moved:
            continue
        lrs.append(state.g_opt.param_groups[0]["lr"])
        updates = (i + 1) // k
        for module, tree in ((state.generator, ref[i][0]), (state.discriminator, ref[i][1])):
            want = {n: v.numpy() for n, v in state_dict_from_jax(tree, {}).items()}
            for name, p in module.named_parameters():
                diff = p.detach().numpy() - want[name]
                if not dust[name]:
                    rms = float(np.sqrt(np.mean(diff ** 2)))
                    assert rms <= 0.05 * lr, f"update {updates} {name}: RMS {rms:.3e}"
                assert float(np.abs(diff).max()) <= 2.5 * lr * (updates + 1), name
    assert state.step == micro
    assert lrs == pytest.approx([2e-4, 2e-4, 1e-4], rel=1e-6)


def test_state_digest_tells_states_apart(env):
    a, step = _trained(env, 1)
    b, _ = _trained(env, 1)
    assert state_digest(a) == state_digest(b)
    step(b, _batch(env))
    diff = {k for k, v in state_digest(b).items() if state_digest(a)[k] != v}
    assert "step" in diff and any(k.startswith("generator/") for k in diff)
    assert any(k.startswith("g_opt/") for k in diff)
