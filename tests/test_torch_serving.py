"""Port parity: the whole serving slice on the CPU.

JAX ``make_infer(model, pipe)(variables, wave)`` and the port's
``make_infer`` with the converted weights run the same numpy-seeded
waveforms (tiny AST, B 2 x 1 s); then the port's export → load round trip,
the HTTP server, the GPU-only guard of ``load_exported``, the export CLI,
and a subprocess check that the port's serving modules import no jax.
Tolerance on the probabilities: 1e-6 absolute (softmax of f32 sigmoid
outputs that agree to ~1e-6, see tests/test_torch_ast.py).
"""

import http.client
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlsc_tpu.data.pipeline import DevicePipeline as JaxPipeline
from dlsc_tpu.data.pipeline import PipelineConfig as JaxPipelineConfig
from dlsc_tpu.models.ast import ASTModel as JaxASTModel
from dlsc_tpu.serving import make_infer as jax_make_infer
from dlsc_tpu_torch.data import wav as W
from dlsc_tpu_torch.data.pipeline import DevicePipeline, PipelineConfig
from dlsc_tpu_torch.models.ast import ASTModel
from dlsc_tpu_torch.models.convert import params_from_jax
from dlsc_tpu_torch.ops import attn_fast, mel_kernel
from dlsc_tpu_torch.server import ModelServer
from dlsc_tpu_torch.serving import export_model, load_exported, make_infer

REPO = Path(__file__).resolve().parent.parent
CLIP = 44_100
SMALL = dict(num_classes=7, emb_dim=64, depth=2, num_heads=2)


def _waves(seed, b=2):
    x = np.random.default_rng(seed).standard_normal((b, CLIP)).astype(np.float32)
    return x / np.abs(x).max(axis=1, keepdims=True)  # peak-normalised: prep is the identity


@pytest.fixture(scope="module")
def slice_pair():
    """(JAX infer, variables, port model, port pipeline) on the same weights."""
    jpipe = JaxPipeline(JaxPipelineConfig(mode="ast", num_classes=7))
    jmodel = JaxASTModel(**SMALL, dtype=jnp.float32, remat=False)
    feats, _ = jpipe.eval_batch(jnp.asarray(_waves(0)), jnp.zeros((2,), jnp.int32))
    variables = jmodel.init({"params": jax.random.key(1)}, feats, train=False)
    model = ASTModel(**SMALL, dtype=torch.float32)
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, variables["params"]), model))
    pipe = DevicePipeline(PipelineConfig(mode="ast", num_classes=7))
    return jax.jit(jax_make_infer(jmodel, jpipe)), variables, model, pipe


@pytest.fixture(scope="module")
def artifact(slice_pair, tmp_path_factory):
    _, _, model, pipe = slice_pair
    return export_model(model, pipe, tmp_path_factory.mktemp("art") / "ast",
                        batch=4, clip_samples=CLIP, meta={"model": "test"})


def test_slice_matches_jax(slice_pair):
    jinfer, variables, model, pipe = slice_pair
    w = _waves(2)
    want = np.asarray(jinfer(variables, jnp.asarray(w)))
    got = make_infer(model, pipe)(torch.from_numpy(w)).numpy()
    assert got.shape == want.shape == (2, 7)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-6)


def test_export_load_roundtrip(slice_pair, artifact):
    _, _, model, pipe = slice_pair
    manifest = json.loads((artifact / "manifest.json").read_text())
    # the JAX manifest's keys, plus what rebuilds the module and pipeline
    assert {"batch", "clip_samples", "platforms", "num_classes", "pipeline_mode",
            "mesh", "model_kwargs", "pipeline_kwargs"} <= set(manifest)
    serve = load_exported(artifact, device="cpu")
    assert serve.manifest["batch"] == 4 and serve.manifest["model"] == "test"
    w = _waves(3)
    np.testing.assert_array_equal(serve(w), make_infer(model, pipe)(torch.from_numpy(w)).numpy())


def test_load_exported_cuda_raises_without_gpu(artifact):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the guard under test cannot trigger")
    with pytest.raises(RuntimeError, match="cuda"):
        load_exported(artifact, device="cuda")


def _post(port, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", path, body=body)
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def test_http_server(artifact, tmp_path):
    """/healthz, a concurrent /predict_raw burst and /predict with WAV bytes
    through the micro-batcher; each answer equals the direct call on its
    clip (padded to the artifact batch) to 1e-6. CPU tensors: no launches."""
    mel_kernel.reset_launches()
    attn_fast.reset_launches()
    srv = ModelServer(artifact, device="cpu", window_ms=20.0)
    httpd = srv.make_http_server("127.0.0.1", 0)
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("GET", "/healthz")
        r = conn.getresponse()
        health = json.loads(r.read())
        conn.close()
        assert r.status == 200 and health["manifest"]["batch"] == 4

        clips = _waves(4, b=3)
        results = [None] * 3

        def hit(i):
            results[i] = _post(port, "/predict_raw", json.dumps(
                {"pcm": clips[i].tolist(), "sample_rate": CLIP}).encode())

        threads = [threading.Thread(target=hit, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        direct = srv.serve(np.concatenate([clips, np.zeros((1, CLIP), np.float32)]))
        for i, (status, payload) in enumerate(results):
            assert status == 200, payload
            np.testing.assert_allclose(payload["probs"], direct[i], rtol=0, atol=1e-6)
            assert payload["top"][0][0] == int(np.argmax(direct[i]))

        path = tmp_path / "clip.wav"
        W.write_wav(path, clips[0], CLIP)
        status, payload = _post(port, "/predict", path.read_bytes())
        assert status == 200, payload
        pcm, sr = W.read_wav(path)
        q = W.peak_normalize(W.to_mono(pcm))
        want = srv.serve(np.stack([q] + [np.zeros(CLIP, np.float32)] * 3))[0]
        np.testing.assert_allclose(payload["probs"], want, rtol=0, atol=1e-6)

        assert _post(port, "/predict_raw", b"{not json")[0] == 400
        assert _post(port, "/nope", b"{}")[0] == 404
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    assert srv.batcher.batches >= 3  # warm-up, the burst, /predict
    assert mel_kernel.launches == 0 and attn_fast.launches == 0


def test_export_cli_with_jax_params(slice_pair, tmp_path):
    """``python -m dlsc_tpu_torch.scripts.export`` with ``+params_npz``: the
    exported artifact serves exactly the converted model."""
    from dlsc_tpu_torch.scripts import export

    _, variables, model, pipe = slice_pair
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(variables["params"])}
    np.savez(tmp_path / "params.npz", **flat)
    out = export.main([
        "model=ast", f"+out={tmp_path / 'art'}", f"+params_npz={tmp_path / 'params.npz'}",
        "dataset.num_classes=7", "+model.emb_dim=64", "+model.depth=2",
        "+model.num_heads=2", "+dtype=float32", "+batch=2", f"+clip_samples={CLIP}"])
    serve = load_exported(out, device="cpu")
    w = _waves(5)
    np.testing.assert_array_equal(serve(w), make_infer(model, pipe)(torch.from_numpy(w)).numpy())


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, loads nothing of jax,
    flax, optax or the JAX package ``dlsc_tpu`` (not even its jax-free
    modules), nor scikit-learn, orbax or tqdm. Those three and matplotlib
    are missing on the card's machine, so the subprocess refuses to import
    them, as that machine does (torch itself tries tqdm and goes on without
    it); a subprocess, because this test process imported jax in conftest."""
    code = (
        "import importlib, pkgutil, sys\n"
        "class Missing:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('sklearn', 'orbax', 'tqdm', 'matplotlib'):\n"
        "            raise ImportError(f'{name} is not installed on the card machine')\n"
        "sys.meta_path.insert(0, Missing())\n"
        "import dlsc_tpu_torch, chip_smoke\n"
        "names = [m.name for m in pkgutil.walk_packages(dlsc_tpu_torch.__path__,\n"
        "                                                'dlsc_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert {'dlsc_tpu_torch.config', 'dlsc_tpu_torch.train.steps',\n"
        "        'dlsc_tpu_torch.scripts.bench', 'dlsc_tpu_torch.ops.augment',\n"
        "        'dlsc_tpu_torch.ops.gmm', 'dlsc_tpu_torch.models.moe',\n"
        "        'dlsc_tpu_torch.models.ast_moe', 'dlsc_tpu_torch.ops.ln_fused',\n"
        "        'dlsc_tpu_torch.models.ast_small',\n"
        "        'dlsc_tpu_torch.models.ast_mini', 'dlsc_tpu_torch.data.prepare',\n"
        "        'dlsc_tpu_torch.data.synthetic', 'dlsc_tpu_torch.data.datamodule',\n"
        "        'dlsc_tpu_torch.data.esc50', 'dlsc_tpu_torch.data.us8k',\n"
        "        'dlsc_tpu_torch.data.loader', 'dlsc_tpu_torch.config.instantiate',\n"
        "        'dlsc_tpu_torch.tracking.tracker', 'dlsc_tpu_torch.utils.profiling',\n"
        "        'dlsc_tpu_torch.train.checkpoint', 'dlsc_tpu_torch.train.loop',\n"
        "        'dlsc_tpu_torch.scripts.train', 'dlsc_tpu_torch.scripts.evaluate',\n"
        "        'dlsc_tpu_torch.scripts.predict', 'dlsc_tpu_torch.models.layers',\n"
        "        'dlsc_tpu_torch.models.envnet_v2', 'dlsc_tpu_torch.models.cnn_esc50',\n"
        "        'dlsc_tpu_torch.models.leaf', 'dlsc_tpu_torch.data.pipeline',\n"
        "        'dlsc_tpu_torch.scripts.bench_infer', 'dlsc_tpu_torch.serving',\n"
        "        'dlsc_tpu_torch.ops.quant', 'dlsc_tpu_torch.utils.remat',\n"
        "        'dlsc_tpu_torch.models.ast', 'dlsc_tpu_torch.scripts.import_vit',\n"
        "        'dlsc_tpu_torch.scripts.export', 'dlsc_tpu_torch.hpo',\n"
        "        'dlsc_tpu_torch.hpo.study', 'dlsc_tpu_torch.hpo.tpe',\n"
        "        'dlsc_tpu_torch.hpo.pruners', 'dlsc_tpu_torch.hpo.hyperband',\n"
        "        'dlsc_tpu_torch.hpo.space', 'dlsc_tpu_torch.hpo.runner',\n"
        "        'dlsc_tpu_torch.hpo.fanova', 'dlsc_tpu_torch.hpo.report_html',\n"
        "        'dlsc_tpu_torch.scripts.optimize_hyperparams',\n"
        "        'dlsc_tpu_torch.scripts.debug_optimize',\n"
        "        'dlsc_tpu_torch.scripts.analyze_study', 'dlsc_tpu_torch.hpo.vmapped',\n"
        "        'dlsc_tpu_torch.native', 'dlsc_tpu_torch.data.cache',\n"
        "        'dlsc_tpu_torch.scripts.prepare_esc50',\n"
        "        'dlsc_tpu_torch.scripts.prepare_urbansound8k',\n"
        "        'dlsc_tpu_torch.scripts.check_specs', 'dlsc_tpu_torch.scripts.tracking_ui',\n"
        "        'dlsc_tpu_torch.scripts.cache_manager', 'dlsc_tpu_torch.ops.dropout_draw',\n"
        "        'dlsc_tpu_torch.parallel.tp', 'dlsc_tpu_torch.parallel.pp_tp',\n"
        "        'dlsc_tpu_torch.parallel.mesh'} <= set(names)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'flax', 'optax', 'dlsc_tpu', 'sklearn', 'orbax', 'tqdm'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
