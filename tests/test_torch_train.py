"""The port's training substrate (``repro_torch.train``, ``launch/train.py``)
against the reference's on the CPU: the cases of ``tests/test_train.py``,
each held port against reference, and the paths those leave out.

Both packages start from the same state: the port's ``train_state_init``
from a seeded generator, handed to the reference as numpy
(``train_state_to_numpy``; its own ``init_params`` draws eagerly and slowly
on the CPU); tokens come from the shared ``TokenStream``. The smoke configs run in float32,
so the two packages differ in the order of their sums only. Tolerances:
  * the loss, the schedule and single AdamW updates: rtol 1e-5 (an ulp of
    the bias corrections' pow and of the sums' order);
  * step-0 gradients: each leaf within GRAD_REL = 1e-4 of its largest
    |value| (sums over a few layers and a 512-wide head, taken in another
    order; observed at about 1e-6);
  * parameters after three steps: rtol 1e-4, atol 1e-4, a thirtieth of a
    step's largest move (lr 3e-3): AdamW's m / sqrt(v) magnifies a
    gradient's last-bit difference where the gradient is near 0;
  * gradient accumulation: the reference's own (rtol 2e-4, atol 2e-5);
  * within the port, exactly: remat against no remat, the slicewise update
    against a whole-leaf one, resume against running straight through, and
    checkpoints, which keep bits in both directions.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import TokenStream as RefTokenStream
from repro.models import forward as j_forward
from repro.train import AdamWConfig as RefAdamWConfig
from repro.train import adamw_init as ref_adamw_init
from repro.train import adamw_update as ref_adamw_update
from repro.train import checkpoint as ref_ckpt
from repro.train import cosine_schedule as ref_cosine_schedule
from repro.train import cross_entropy_loss as ref_cross_entropy_loss
from repro.train import make_train_step as ref_make_train_step
from repro.train import train_state_init as ref_train_state_init
from repro_torch import configs
from repro_torch.convert import params_from_jax, train_state_from_jax, train_state_to_numpy
from repro_torch.data import TokenStream
from repro_torch.models import transformer
from repro_torch.train import (
    AdamWConfig,
    abstract_train_state,
    adamw_init,
    adamw_update,
    cosine_schedule,
    cross_entropy_loss,
    make_train_step,
    train_state_init,
)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optim
from repro_torch.train.step import loss_and_grads

GRAD_REL = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _batch(stream, i, device="cpu"):
    b = stream.batch(i)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v).to(device) for k, v in b.items()})


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, train_state_to_numpy(tree))


def _states(arch, opt, seed, **replace):
    """The port's initial train state of ``arch``'s smoke config, and the
    same state as the reference's (with its config)."""
    jcfg = jconfigs.get_smoke_config(arch).replace(**replace)
    tcfg = configs.get_smoke_config(arch).replace(**replace)
    state = train_state_init(tcfg, opt, torch.Generator().manual_seed(seed))
    return jcfg, tcfg, _to_jax(state), state


def _opts(**kw):
    return RefAdamWConfig(**kw), AdamWConfig(**kw)


def _assert_tree_close(got, want, **tol):
    for g, w in zip(_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32), **tol)


# -- the loss and the schedule -------------------------------------------------------------

@pytest.mark.parametrize("z_loss", [0.0, 1e-4, 0.1])
def test_cross_entropy_with_mask_and_z_loss_is_the_references(z_loss):
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((2, 9, 37)) * 4).astype(np.float32)
    labels = rng.integers(0, 37, (2, 9)).astype(np.int32)
    labels[0, 3:] = -1
    labels[1, 0] = -1
    want, wn = ref_cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels), z_loss_coeff=z_loss)
    got, n = cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels), z_loss_coeff=z_loss)
    assert int(n) == int(wn) == 11
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_cross_entropy_masks_every_token_and_takes_bf16_logits():
    logits = torch.zeros((1, 4, 8))
    loss, n = cross_entropy_loss(logits, torch.tensor([[1, 2, -1, -1]]))
    assert int(n) == 2 and float(loss) == pytest.approx(np.log(8), rel=1e-5)
    loss, n = cross_entropy_loss(logits, torch.full((1, 4), -1))
    assert int(n) == 1 and float(loss) == 0.0  # the reference's max(n, 1)
    x = torch.randn((2, 3, 16), generator=torch.Generator().manual_seed(0)).bfloat16()
    lab = torch.tensor([[1, 2, 3], [4, 5, 6]])
    assert float(cross_entropy_loss(x, lab)[0]) == float(cross_entropy_loss(x.float(), lab)[0])


@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 10), (5, 5)])
def test_cosine_schedule_over_every_step_is_the_references(warmup, total):
    ropt, opt = _opts(peak_lr=1.0, warmup_steps=warmup, total_steps=total, min_lr_ratio=0.1)
    steps = np.arange(0, total + 12)
    want = np.asarray(jax.vmap(ref_cosine_schedule(ropt))(jnp.asarray(steps)))
    got = cosine_schedule(opt)(torch.from_numpy(steps)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    if warmup:
        assert float(cosine_schedule(opt)(torch.tensor(0))) == pytest.approx(1.0 / warmup)


# -- AdamW ------------------------------------------------------------------------------------

def _grad_tree(rng, dtype):
    def arr(shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    tree = {"blocks": {"w": arr((3, 8, 5)), "gate": arr((3,))}, "embed": arr((11, 6)), "b": arr(())}
    return tree if dtype == "float32" else jax.tree.map(lambda a: a.astype(jnp.bfloat16), tree)


@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_adamw_update_is_the_references(mu_dtype, param_dtype, clip):
    rng = np.random.default_rng(7)
    ropt, opt = _opts(peak_lr=0.1, warmup_steps=2, total_steps=10, clip_norm=clip, mu_dtype=mu_dtype)
    params, grads = _grad_tree(rng, param_dtype), _grad_tree(rng, param_dtype)
    mu, nu = ref_adamw_init(params, ropt)
    t = {name: params_from_jax(_np(x)) for name, x in (("p", params), ("mu", mu), ("nu", nu))}
    for step in range(3):
        grads = _grad_tree(rng, param_dtype)
        params, mu, nu, gnorm = ref_adamw_update(grads, params, mu, nu, jnp.asarray(step), ropt)
        t["p"], t["mu"], t["nu"], tnorm = adamw_update(
            params_from_jax(_np(grads)), t["p"], t["mu"], t["nu"], torch.tensor(step, dtype=torch.int32), opt)
        np.testing.assert_allclose(float(tnorm), float(gnorm), rtol=1e-5)
        tol = dict(rtol=1e-5, atol=1e-6) if param_dtype == mu_dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
        for got, want in ((t["p"], params), (t["mu"], mu), (t["nu"], nu)):
            _assert_tree_close(got, want, **tol)
            assert [g.dtype for g in _leaves(got)] == [
                getattr(torch, str(w.dtype)) for w in jax.tree.leaves(want)]


def test_adamw_moves_towards_the_gradient():
    opt = AdamWConfig(peak_lr=0.1, warmup_steps=0, total_steps=10, weight_decay=0.0)
    params, grads = {"w": torch.ones(4)}, {"w": torch.ones(4)}
    mu, nu = adamw_init(params, opt)
    p2, _, _, gnorm = adamw_update(grads, params, mu, nu, torch.tensor(0), opt)
    assert float(gnorm) == pytest.approx(2.0) and bool((p2["w"] < 1.0).all())
    assert p2["w"] is params["w"]  # in place: the reference's donation


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_slicewise_update_is_bitwise_the_whole_leafs(monkeypatch, dtype):
    g = torch.Generator().manual_seed(5)
    opt = AdamWConfig(peak_lr=0.01, warmup_steps=0, total_steps=10, mu_dtype="bfloat16")

    def tree():
        return {"stack": torch.randn((6, 40, 30), generator=g).to(dtype),
                "embed": torch.randn((97, 31), generator=g).to(dtype), "s": torch.randn((), generator=g)}

    params, grads = tree(), tree()
    runs = []
    for limit in (1 << 26, 257):  # whole leaves, then slices of a layer or a few rows
        monkeypatch.setattr(optim, "SLICE_ELEMS", limit)
        p = {k: v.clone() for k, v in params.items()}
        mu, nu = adamw_init(p, opt)
        for step in range(2):
            adamw_update(grads, p, mu, nu, torch.tensor(step), opt)
        runs.append(_leaves(p) + _leaves(mu) + _leaves(nu))
    assert len(list(optim.slices(params["stack"]))) == 6
    assert len(list(optim.slices(params["embed"]))) == 13  # 8 rows of 31 a slice
    assert all(torch.equal(a, b) for a, b in zip(*runs))


# -- gradients and steps against the reference ---------------------------------------------------

def _memory(cfg, batch, seed=0):
    length = cfg.num_image_tokens if cfg.family == "vlm" else cfg.encoder_seq
    return np.random.default_rng(seed).standard_normal((batch, length, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_step0_gradients_are_jax_grad_of_the_references_loss(arch):
    jcfg, tcfg, jstate, tstate = _states(arch, AdamWConfig(), 0)
    jp, tp = jstate["params"], tstate["params"]
    seq = jcfg.xlstm.chunk if jcfg.xlstm else 12  # xlstm: one chunk, where its scan is exact
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, seq + 1)).astype(np.int32)
    mem = _memory(jcfg, 2) if jcfg.family in ("vlm", "audio") else None

    def loss_fn(params):
        logits = j_forward(params, jcfg, jnp.asarray(toks[:, :-1]),
                           memory=None if mem is None else jnp.asarray(mem))
        return ref_cross_entropy_loss(logits, jnp.asarray(toks[:, 1:]), z_loss_coeff=1e-4)[0]

    want_loss, want = jax.jit(jax.value_and_grad(loss_fn))(jp)
    loss, grads = loss_and_grads(tp, tcfg, torch.from_numpy(toks[:, :-1]).long(),
                                 torch.from_numpy(toks[:, 1:]).long(),
                                 None if mem is None else torch.from_numpy(mem))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    names = [n for n, _ in ckpt._flatten_with_names(tp)]
    for name, g, w in zip(names, grads, jax.tree.leaves(want)):
        w = np.asarray(w, np.float32)
        err = np.abs(g.numpy() - w).max()
        assert err <= GRAD_REL * np.abs(w).max() + 1e-7, (name, err, np.abs(w).max())


def test_loss_over_three_steps_is_the_references():
    ropt, opt = _opts(peak_lr=3e-3, warmup_steps=1, total_steps=10)
    cfg, tcfg, rstate, tstate = _states("qwen3_4b", opt, 0)
    rstep, tstep = jax.jit(ref_make_train_step(cfg, ropt)), make_train_step(tcfg, opt)
    stream = RefTokenStream(cfg.vocab_size, 24, 4, seed=1)
    losses = []
    for i in range(3):
        jb, tb = _batch(stream, i % 2)
        rstate, rm = rstep(rstate, jb)
        tstate, tm = tstep(tstate, tb)
        np.testing.assert_allclose(float(tm["loss"]), float(rm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(rm["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(float(tm["lr"]), float(rm["lr"]), rtol=1e-6)
        losses.append(float(tm["loss"]))
    assert int(tstate["step"]) == 3
    _assert_tree_close(tstate["params"], rstate["params"], rtol=1e-4, atol=1e-4)
    assert losses[-1] < losses[0]


def test_grad_accum_equivalence():
    cfg = configs.get_smoke_config("granite_20b")
    opt = AdamWConfig(peak_lr=1e-3, warmup_steps=0, total_steps=10, clip_norm=0.0)
    stream = TokenStream(cfg.vocab_size, 16, 8, seed=2)
    _, batch = _batch(stream, 0)
    outs = []
    for accum in (1, 4):
        state = train_state_init(cfg, opt, torch.Generator().manual_seed(3))
        outs.append(make_train_step(cfg, opt, accum=accum)(state, batch))
    (a, ma), (b, mb) = outs
    np.testing.assert_allclose(float(ma["loss"]), float(mb["loss"]), rtol=1e-5)
    for la, lb in zip(_leaves(a["params"]), _leaves(b["params"])):
        np.testing.assert_allclose(la.numpy(), lb.numpy(), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("arch", ["qwen3_4b", "zamba2_2_7b", "xlstm_1_3b", "seamless_m4t_medium"])
def test_remat_is_bitwise_no_remat(monkeypatch, arch):
    cfg = configs.get_smoke_config(arch)
    params = train_state_init(cfg, AdamWConfig(), torch.Generator().manual_seed(0))["params"]
    toks = torch.randint(0, cfg.vocab_size, (2, 9), generator=torch.Generator().manual_seed(1))
    mem = torch.from_numpy(_memory(cfg, 2)) if cfg.family == "audio" else None
    runs = []
    for remat in (True, False):
        monkeypatch.setattr(transformer, "REMAT", remat)
        runs.append(loss_and_grads(params, cfg, toks[:, :-1], toks[:, 1:], mem))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_stacked_parameters_are_unbound_once_under_grad():
    cfg = configs.get_smoke_config("qwen3_4b")
    params = train_state_init(cfg, AdamWConfig(), torch.Generator().manual_seed(0))["params"]
    stack = params["blocks"]["mlp"]["w_up"]
    views = transformer.stack_views(params["blocks"], False)
    assert views(1)["mlp"]["w_up"]._base is stack
    stack.requires_grad_(True)
    with torch.enable_grad():
        parts = transformer.stack_views(params["blocks"], True)
        assert parts(0)["mlp"]["w_up"].grad_fn.name() == "UnbindBackward0"
    stack.requires_grad_(False)


# -- checkpoints -------------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    cfg = configs.get_smoke_config("xlstm_1_3b")
    opt = AdamWConfig()
    state = train_state_init(cfg, opt, torch.Generator().manual_seed(0))
    d = str(tmp_path / "ck")
    ckpt.save(d, 7, state)
    assert ckpt.latest_step(d) == 7
    restored = ckpt.restore(d, target=abstract_train_state(cfg, opt))
    for a, b in zip(_leaves(state), _leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    flat = ckpt.restore(d)
    assert set(flat) == {n for n, _ in ckpt._flatten_with_names(state)}


def test_checkpoint_async_and_gc(tmp_path):
    d = str(tmp_path / "ck")
    state = {"w": torch.arange(8.0), "step": torch.tensor(1)}
    saver = ckpt.AsyncCheckpointer(d)
    for s in (1, 2, 3, 4, 5):
        state["step"] = torch.tensor(s)
        saver.save_async(s, state)
        state["w"] += 1  # the snapshot is taken before save_async returns
    saver.wait()
    assert ckpt.latest_step(d) == 5
    steps = sorted(int(x.split("_")[1]) for x in os.listdir(d) if x.startswith("step_"))
    assert steps == [3, 4, 5]
    assert torch.equal(ckpt.restore(d)["w"], torch.arange(8.0) + 4)


def test_checkpoint_resume_exact(tmp_path):
    cfg = configs.get_smoke_config("granite_20b")
    opt = AdamWConfig(peak_lr=1e-3, warmup_steps=0, total_steps=20)
    step = make_train_step(cfg, opt)
    stream = TokenStream(cfg.vocab_size, 16, 4, seed=5)

    ref = train_state_init(cfg, opt, torch.Generator().manual_seed(1))
    for i in range(6):
        ref, _ = step(ref, _batch(stream, i)[1])

    d = str(tmp_path / "ck")
    st = train_state_init(cfg, opt, torch.Generator().manual_seed(1))
    for i in range(3):
        st, _ = step(st, _batch(stream, i)[1])
    ckpt.save(d, 3, st)
    st = ckpt.restore(d, target=abstract_train_state(cfg, opt))
    for i in range(int(st["step"]), 6):
        st, _ = step(st, _batch(stream, i)[1])
    assert all(torch.equal(a, b) for a, b in zip(_leaves(ref), _leaves(st)))


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_checkpoints_cross_read_with_bf16_leaves(tmp_path, direction):
    ropt, opt = _opts(mu_dtype="bfloat16")
    _, tcfg, rstate, tstate = _states("qwen3_4b", opt, 2, param_dtype="bfloat16")
    d = str(tmp_path / "ck")
    if direction == "reference_to_port":
        ref_ckpt.save(d, 4, rstate)
        got = ckpt.restore(d, target=abstract_train_state(tcfg, opt))
        assert got["params"]["embed"].dtype == torch.bfloat16
        got = train_state_to_numpy(got)
    else:
        ckpt.save(d, 4, tstate)
        got = ref_ckpt.restore(d, target=jax.eval_shape(lambda: rstate))
    for name, g, w in zip((n for n, _ in ckpt._flatten_with_names(tstate)),
                          jax.tree.leaves(got), jax.tree.leaves(_np(rstate))):
        assert g.dtype == w.dtype and _bits(g) == _bits(w), name


def _bits(a):
    return np.asarray(a).reshape(-1).view(np.uint8).tobytes()


def test_restore_onto_a_mesh_waits_for_sharding(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 3, {"w": torch.ones((4, 8))}, specs={"w": ("data", "model")})
    assert ref_ckpt.restore(d)["w"].shape == (4, 8)  # the spec is carried, as the reference's
    with pytest.raises(NotImplementedError, match="item 18"):
        ckpt.restore(d, mesh=object())


def test_train_state_converters_and_the_abstract_state():
    cfg = jconfigs.get_smoke_config("zamba2_2_7b").replace(param_dtype="bfloat16")
    ropt, opt = _opts()
    state = jax.jit(ref_train_state_init, static_argnums=(0, 1))(cfg, ropt, jax.random.PRNGKey(0))
    port = train_state_from_jax(_np(state))
    assert port["params"]["embed"].dtype == torch.bfloat16 and port["step"].dtype == torch.int32
    back = train_state_to_numpy(port)
    assert all(a.dtype == b.dtype and _bits(a) == _bits(b)
               for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(_np(state))))
    cfg = jconfigs.get_smoke_config("zamba2_2_7b")
    abstract = abstract_train_state(configs.get_smoke_config("zamba2_2_7b"), opt)
    want = jax.eval_shape(lambda: ref_train_state_init(cfg, ropt, jax.random.PRNGKey(0)))
    assert [(tuple(a.shape), str(a.dtype).split(".")[-1]) for a in _leaves(abstract)] == [
        (tuple(w.shape), str(w.dtype)) for w in jax.tree.leaves(want)]
    assert all(a.device.type == "meta" for a in _leaves(abstract))


# -- the driver --------------------------------------------------------------------------------

def test_launch_train_smoke_on_the_cpu_resumes_from_its_checkpoint(tmp_path, capsys):
    from repro_torch.launch import train as launch_train

    d = str(tmp_path / "ck")
    common = ["--smoke", "--device", "cpu", "--batch", "2", "--seq", "16", "--log-every", "2",
              "--ckpt-dir", d, "--ckpt-every", "2"]
    assert launch_train.main(common + ["--steps", "4"]) == 0
    first = capsys.readouterr().out.splitlines()
    assert first[0].startswith("qwen3-4b-smoke:") and first[-1].startswith("done: loss")
    assert [line.split()[1] for line in first if line.startswith("step")] == ["2", "4"]
    assert ckpt.latest_step(d) == 4
    assert launch_train.main(common + ["--steps", "6"]) == 0
    second = capsys.readouterr().out.splitlines()
    assert second[0] == "restored checkpoint at step 4"
    assert [line.split()[1] for line in second if line.startswith("step")] == ["6"]


def test_the_training_slice_imports_neither_jax_nor_the_reference():
    import ast

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pkg = os.path.join(root, "src", "repro_torch")
    paths = [os.path.join(pkg, "launch", "train.py"), os.path.join(pkg, "kernels", "autograd.py"),
             os.path.join(root, "examples", "train_lm_torch.py")]
    for sub in ("train", "data"):
        paths += [os.path.join(pkg, sub, f) for f in os.listdir(os.path.join(pkg, sub)) if f.endswith(".py")]
    assert len(paths) == 11
    for path in paths:
        with open(path) as f:
            tree = ast.parse(f.read())
        mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        mods += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module and not n.level]
        assert not [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "repro")], (path, mods)
