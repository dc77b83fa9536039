"""The PyTorch port's encoder-decoder family (whisper-medium) against the
JAX package, on the CPU in f32.

Two configurations: whisper's smoke config (2 encoder and 2 decoder
layers, 4 / 2 heads of 16, 16 source frames), and the same at whisper's
own heads shrunk (2 / 2 heads of 64, group 1) over 23 source frames with
``kv_chunk`` 8 on both sides, so the plain attention's last chunk of keys
is ragged in the encoder and in the decoder's self-attention (the
cross-attention keeps the reference's default chunk, as its call does).
The same weights (JAX ``init_lm`` → numpy → ``params_from_numpy``) and
numpy-seeded frame embeddings and tokens go to both packages: forward
logits; the prefill step; serve steps with the same ``enc_out`` in both
caches; decode steps on the port's own ``encode`` output against the
reference's forward; ``lm_loss`` and every gradient (the encoder's and the
cross-attention's included) against ``jax.value_and_grad`` with the
port's remat on and off; one AdamW train step against the reference's
``make_train_step``; the scda bytes of the parameters and of a training
state; and the training loop from a data source that adds frame
embeddings, killed and resumed.

Tolerance: TOL, 1e-4 (logits, losses, AdamW moments and metrics; each
gradient by relative L2).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import restore as jax_restore  # noqa: E402
from repro.checkpoint import save as jax_save  # noqa: E402
from repro.configs import get_config, smoke  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import step as jstep  # noqa: E402

from repro_torch import serve  # noqa: E402
from repro_torch.checkpoint import pytree_io as tio  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs import smoke as tsmoke  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticTokens  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "whisper-medium"
B, S, TRAIN_S, CHUNK = 2, 10, 16, 8
#: name -> (config overrides, kv_chunk on both sides)
CONFIGS = {
    "smoke": ({}, 512),
    "whisper heads": (dict(n_heads=2, n_kv_heads=2, head_dim=64,
                           max_source_len=23), 8),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The smoke model's ops are tiny: one thread is several times faster
    than a pool shared with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tp(tree):
    """Fresh port leaves of a tree of the reference's arrays."""
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), "cpu")


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _named(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, tuple):
        return [x for f in tree._fields
                for x in _named(getattr(tree, f), f"{prefix}{f}/")]
    return [(prefix[:-1], tree)]


def _frames(cfg, seed, batch=B):
    return np.random.default_rng(seed).standard_normal(
        (batch, cfg.max_source_len, cfg.d_model)).astype(np.float32)


def _tokens(cfg, n, seed, batch=B):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (batch, n)).astype(np.int32)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    over, kv_chunk = CONFIGS[request.param]
    cfg = dataclasses.replace(smoke(get_config(ARCH)), **over)
    tcfg = dataclasses.replace(tsmoke(tget(ARCH)), **over)
    jp = jlm.init_lm(cfg, jax.random.PRNGKey(0))
    return cfg, tcfg, jp, _tp(jp), kv_chunk


def test_config_is_an_encoder_decoder(model):
    cfg, tcfg, _, tp, kv_chunk = model
    assert tcfg.family == "encdec" and tcfg.tie_embeddings
    assert "lm_head" not in tp
    assert sorted(tp["layers"]) == ["attn", "cross", "ln1", "ln2", "ln_x",
                                    "mlp"]
    assert sorted(tp["enc_layers"]) == ["attn", "ln1", "ln2", "mlp"]
    assert tuple(tp["enc_layers"]["attn"]["wq"].shape) == (
        tcfg.encoder_layers, tcfg.d_model, tcfg.n_heads, tcfg.head_dim_)
    assert tuple(tp["enc_norm"].shape) == (tcfg.d_model,)
    if kv_chunk < 512:    # the last chunk of keys is ragged
        assert tcfg.max_source_len % kv_chunk and S % kv_chunk


def test_forward_matches_jax(model):
    cfg, tcfg, jp, tp, kv_chunk = model
    tok, frames = _tokens(cfg, S, 0), _frames(cfg, 0)
    want = jlm.forward(cfg, jp, jnp.asarray(tok),
                       enc_embeds=jnp.asarray(frames), kv_chunk=kv_chunk)
    got = tlm.forward(tcfg, tp, torch.from_numpy(tok),
                      enc_embeds=torch.from_numpy(frames), kv_chunk=kv_chunk)
    assert got.shape == (B, S, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_forward_needs_the_encoder_input(model):
    _, tcfg, _, tp, _ = model
    with pytest.raises(ValueError, match="enc_embeds"):
        tlm.forward(tcfg, tp, torch.zeros((1, 4), dtype=torch.int32))


def test_prefill_step_matches_jax(model):
    cfg, tcfg, jp, tp, _ = model
    tok, frames = _tokens(cfg, S, 1), _frames(cfg, 1)
    want = jstep.make_prefill_step(cfg)(jp, {
        "tokens": jnp.asarray(tok), "enc_embeds": jnp.asarray(frames)})
    got = tstep.make_prefill_step(tcfg)(tp, {
        "tokens": torch.from_numpy(tok),
        "enc_embeds": torch.from_numpy(frames)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_serve_steps_match_jax(model):
    """6 decode steps into a cache of 8, the same enc_out (random values,
    as the reference's tests/test_archs.py fills it) in both caches: each
    step's logits and the self-attention caches within TOL, enc_out left
    as it was."""
    cfg, tcfg, jp, tp, _ = model
    tok = _tokens(cfg, 6, 2)
    enc = _frames(cfg, 2)
    jcache = jlm.init_cache(cfg, B, 8)
    jcache["enc_out"] = jnp.asarray(enc)
    tcache = tlm.init_cache(tcfg, B, 8, device="cpu")
    assert tuple(tcache["enc_out"].shape) == tuple(jcache["enc_out"].shape)
    tcache["enc_out"].copy_(torch.from_numpy(enc))
    step = jax.jit(lambda p, c, t: jlm.serve_step(cfg, p, c, t))
    for i in range(tok.shape[1]):
        jl, jcache = step(jp, jcache, jnp.asarray(tok[:, i:i + 1]))
        tl, tcache = tlm.serve_step(tcfg, tp, tcache,
                                    torch.from_numpy(tok[:, i:i + 1]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert int(tcache["pos"]) == tok.shape[1]
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(jcache[name]), **TOL)
    np.testing.assert_array_equal(tcache["enc_out"].numpy(), enc)


def _decode(tcfg, tp, tok, enc_out, max_len):
    """The port's serve steps over ``tok`` with ``enc_out`` in the cache:
    (B, steps, vocab) logits."""
    cache = tlm.init_cache(tcfg, tok.shape[0], max_len, device="cpu")
    cache["enc_out"].copy_(enc_out)
    outs = []
    for i in range(tok.shape[1]):
        logits, cache = tlm.serve_step(tcfg, tp, cache, tok[:, i:i + 1])
        outs.append(logits)
    return torch.stack(outs, 1)


def test_decode_matches_the_references_forward(model):
    """The port encodes the frames once into the cache and decodes the
    tokens one by one: every step's logits equal the reference's forward
    over the same frames and tokens."""
    cfg, tcfg, jp, tp, kv_chunk = model
    tok, frames = _tokens(cfg, S, 3), _frames(cfg, 3)
    want = jlm.forward(cfg, jp, jnp.asarray(tok),
                       enc_embeds=jnp.asarray(frames), kv_chunk=kv_chunk)
    with torch.inference_mode():
        enc_out = tlm.encode(tcfg, tp, torch.from_numpy(frames), kv_chunk)
        got = _decode(tcfg, tp, torch.from_numpy(tok), enc_out, S)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_generate_takes_enc_out_and_needs_it(model):
    """serve.generate writes enc_out into its cache: its greedy tokens are
    those of the serve steps fed the same enc_out; without enc_out it
    raises."""
    cfg, tcfg, _, tp, _ = model
    prompts = torch.from_numpy(_tokens(cfg, 4, 4))
    with torch.inference_mode():
        enc_out = tlm.encode(tcfg, tp, torch.from_numpy(_frames(cfg, 4)))
        out = serve.generate(tcfg, tp, prompts, 3, max_len=8,
                             enc_out=enc_out)
        seq = torch.cat([prompts, out["tokens"][:, :2]], 1)
        logits = _decode(tcfg, tp, seq, enc_out, 8)
    np.testing.assert_array_equal(
        logits[:, 3:].argmax(-1).numpy(), out["tokens"].numpy())
    with pytest.raises(ValueError, match="enc_out"):
        serve.generate(tcfg, tp, prompts, 1, max_len=8)


def test_serve_example_runs_on_the_cpu(capsys):
    out = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--gen-len", "4", "--prompt-len", "3", "--max-len",
                      "8"])
    assert tuple(out["tokens"].shape) == (4, 4)
    assert "served 4 requests" in capsys.readouterr().out


# ----------------------------------------------------------------- training --
def _batch(cfg, seed):
    seq = _tokens(cfg, TRAIN_S + 1, seed)
    return seq[:, :-1], seq[:, 1:], _frames(cfg, seed)


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_gradients_match_jax(model, remat):
    """lm_loss and every parameter's gradient, the encoder's and the
    cross-attention's included, against jax.value_and_grad of the
    reference's lm_loss (whose scans remat each layer); ``remat`` runs the
    port's encoder and decoder layers under torch.utils.checkpoint or
    not."""
    cfg, tcfg, jp, _, kv_chunk = model
    tok, lab, frames = _batch(cfg, 5)
    jloss, jgrads = jax.value_and_grad(lambda p: jlm.lm_loss(
        cfg, p, jnp.asarray(tok), jnp.asarray(lab), loss_chunk=CHUNK,
        enc_embeds=jnp.asarray(frames), kv_chunk=kv_chunk))(jp)
    want = dict(_named(jax.tree_util.tree_map(np.asarray, jgrads)))
    tp = _tp(jp)
    named = _named(tp)
    leaves = [p.requires_grad_() for _, p in named]
    loss = tlm.lm_loss(tcfg, tp, torch.from_numpy(tok), torch.from_numpy(lab),
                       loss_chunk=CHUNK, remat=remat, kv_chunk=kv_chunk,
                       enc_embeds=torch.from_numpy(frames))
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    grads = torch.autograd.grad(loss, leaves)
    assert sorted(want) == [name for name, _ in named]
    for name in ("layers/cross/wq", "layers/cross/wk", "layers/cross/wv",
                 "layers/cross/wo", "layers/ln_x", "enc_layers/attn/wq",
                 "enc_layers/mlp/w_up", "enc_norm"):
        assert name in want
    for (name, _), g in zip(named, grads):
        w = want[name]
        rel = np.linalg.norm(g.numpy() - w) / np.linalg.norm(w)
        assert rel <= TOL["rtol"], f"{name}: relative L2 {rel}"


def _step(cfg, tcfg, jp, batch):
    """One train step in each package from the same weights and batch:
    (reference's (params, state, metrics), port's)."""
    tok, lab, frames = batch
    opt = jadamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    want = jstep.make_train_step(cfg, opt, loss_chunk=CHUNK)(
        jp, jadamw.init(jp), {"tokens": jnp.asarray(tok),
                              "labels": jnp.asarray(lab),
                              "enc_embeds": jnp.asarray(frames)})
    tp = _tp(jp)
    got = tstep.make_train_step(
        tcfg, tadamw.AdamWConfig(**opt.__dict__), loss_chunk=CHUNK)(
        tp, tadamw.init(tp), {"tokens": torch.from_numpy(tok),
                              "labels": torch.from_numpy(lab).long(),
                              "enc_embeds": torch.from_numpy(frames)})
    return want, got


def test_train_step_matches_jax(model):
    """One make_train_step step with the batch's enc_embeds: the updated
    parameters, both AdamW moments and the metrics within TOL of the
    reference's step."""
    cfg, tcfg, jp, _, _ = model
    (jp2, js2, jm), (tp2, ts2, tm) = _step(cfg, tcfg, jp, _batch(cfg, 6))
    for tree, ref in ((tp2, jp2), (ts2.mu, js2.mu), (ts2.nu, js2.nu)):
        w = dict(_named(jax.tree_util.tree_map(np.asarray, ref)))
        got = _named(tree)
        assert sorted(w) == [name for name, _ in got]
        for name, t in got:
            np.testing.assert_allclose(t.detach().numpy(), w[name],
                                       err_msg=name, **TOL)
    assert int(ts2.count) == int(js2.count) == 1
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k,
                                   **TOL)


# -------------------------------------------------------------- checkpoints --
def test_checkpoint_bytes_match_jax_and_restore_in_both(tmp_path, model):
    """The parameters, and the training state after one step (parameters
    and AdamW moments), saved by the port with the reference's vendor
    string: the same bytes as repro.checkpoint.save's; each package
    restores the other's file bit-exactly."""
    cfg, tcfg, jp, _, _ = model
    (jp2, js2, _), _ = _step(cfg, tcfg, jp, _batch(cfg, 7))
    states = (("params", jp, tlm.init_lm(tcfg, 0, device="meta")),
              ("state", {"params": jp2, "opt": js2},
               tloop.init_state(tcfg, 0, "meta")))
    for what, jtree, like in states:
        ref, port = (str(tmp_path / f"{what}-{who}.scda")
                     for who in ("ref", "port"))
        jax_save(ref, jtree, step=7)
        tio.save(port, _tp(jtree), step=7, vendor=tio.REFERENCE_VENDOR)
        with open(ref, "rb") as a, open(port, "rb") as b:
            assert a.read() == b.read(), what
        got, step = jax_restore(port, like=jax.eval_shape(lambda: jtree))
        assert step == 7
        for (n, g), (_, w) in zip(
                jax.tree_util.tree_flatten_with_path(got)[0],
                jax.tree_util.tree_flatten_with_path(jtree)[0]):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                          err_msg=jax.tree_util.keystr(n))
        got, step = tio.restore(ref, like=like, device="cpu")
        assert step == 7
        want = _named(_tp(jtree))
        assert [n for n, _ in _named(got)] == [n for n, _ in want]
        for (name, a), (_, b) in zip(_named(got), want):
            assert torch.equal(a, b), f"{what} {name}"


class FramedTokens(SyntheticTokens):
    """The synthetic tokens and, for each step, seeded random frame
    embeddings (B, max_source_len, d): the encoder's input, which the
    token pipeline does not yield."""

    def __init__(self, cfg, data: DataConfig):
        super().__init__(data)
        self.shape = (data.global_batch, cfg.max_source_len, cfg.d_model)

    def sharded_batch(self, step, device):
        batch = super().sharded_batch(step, device)
        gen = torch.Generator().manual_seed(self.cfg.seed * 1000 + step)
        batch["enc_embeds"] = torch.randn(self.shape, generator=gen).to(
            device)
        return batch


def test_training_loop_resumes_from_a_kill(tmp_path):
    """train.loop.train from a data source that adds frame embeddings: a
    run killed after step 2's checkpoint resumes from it and ends where an
    uninterrupted run ends, bit for bit."""
    tcfg = tsmoke(tget(ARCH))
    data = FramedTokens(tcfg, DataConfig(vocab=tcfg.vocab, seq_len=TRAIN_S,
                                         global_batch=B, seed=3))

    def run(path, hooks=None):
        loop = tloop.TrainLoopConfig(total_steps=5, ckpt_every=2,
                                     ckpt_dir=str(path), log_every=100)
        return tloop.train(tcfg, loop, tadamw.AdamWConfig(total_steps=5),
                           data=data, hooks=hooks, device="cpu")

    whole = run(tmp_path / "a")
    with pytest.raises(SystemExit):
        run(tmp_path / "b", dict(should_die=lambda s: s == 2))
    resumed = run(tmp_path / "b")
    assert resumed["start_step"] == 2
    assert resumed["losses"] == whole["losses"][3:]
    for (name, a), (_, b) in zip(_named(resumed["state"]),
                                 _named(whole["state"])):
        assert torch.equal(a, b), name
    for out in (whole, resumed):
        out["manager"].close()


def test_launcher_refuses_the_family(tmp_path, capsys):
    """The launcher's synthetic tokens carry no frame embeddings: it
    refuses whisper and names the missing input."""
    from repro_torch.launch import train as launch
    with pytest.raises(SystemExit):
        launch.main(["--arch", ARCH, "--device", "cpu", "--ckpt-dir",
                     str(tmp_path)])
    assert "enc_embeds" in capsys.readouterr().err
