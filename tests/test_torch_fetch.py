"""Download on a miss, the fetch script and the real-weights runbook,
against the JAX package, through a loopback server only.

A test here reaches no host but 127.0.0.1: the publication URLs of both
packages (and of ``scripts/torch_fetch_weights.py``) are pointed at a
loopback server (``chip_smoke.loopback_server``, laid out as the
publication servers' paths) or at a loopback port nothing listens on.

- Both zoos download the tiny golden checkpoints (stylegan2_tiny.npz in
  rosinality's file layout, proggan_tiny.npz as a gandissect ``.pth`` in
  the legacy serialization): the two files written equal the served one
  byte for byte, and the params are equal (0 difference).
- Both mask registries download ``dome2tree.json``, served compact, and
  write the same bytes.
- A 404, a closed port, a server that never answers and a body cut short
  each raise ``FileNotFoundError`` naming the URL, within the timeout,
  leaving no ``.tmp``.
- The fetch script fetches its groups with the JAX script's URLs into the
  places the port reads, skips what is present and reports a failure.
- The gated suite has one counterpart per test of
  ``tests/test_real_weights.py``, skips each naming its missing file, and
  the runbook counts its outcomes an artifact, failing on a bad file.
- Phase 41's check on the CPU at 8 px.
"""

import ast
import contextlib
import http.server
import json
import os
import pathlib
import socket
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from rewriting_torch.convert import params_from_jax
from rewriting_torch.metrics import distances, fid, load_mask, slimnet
from rewriting_torch.models import zoo
from rewriting_torch.models.proggan import ProgressiveGenerator
from rewriting_torch.models.stylegan2 import SeqStyleGAN2
from rewriting_torch.segment import faceparse
from rewriting_torch.utils import download
from rewriting_tpu.metrics import load_mask as jax_load_mask
from rewriting_tpu.models import zoo as jax_zoo
from rewriting_tpu.models.stylegan2 import SeqStyleGAN2 as JaxSeqStyleGAN2

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SIZE, STYLE_DIM, N_MLP = 16, 64, 2        # stylegan2_tiny.npz's model
FAIL_WITHIN = 10.0                        # seconds; the timeout patched to 1
fetch_script = chip_smoke.fetch_script()


def _report_script():
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        import torch_real_weights_report
    finally:
        sys.path.remove(str(ROOT / "scripts"))
    return torch_real_weights_report


report_script = _report_script()


def served_path(server, url):
    """Where `server` (the fixture's) serves `url`, a publication URL
    already pointed at it."""
    root, base = server
    assert url.startswith(base), url
    path = root / url[len(base):]
    path.parent.mkdir(parents=True, exist_ok=True)
    return path


@pytest.fixture
def server(tmp_path):
    """(root, base URL) of a loopback server laid out as the publication
    servers, with every publication URL of both packages and the fetch
    script pointed at it."""
    root = tmp_path / "served"
    root.mkdir()
    with chip_smoke.loopback_server(str(root)) as base, \
            chip_smoke.publication_urls(base, zoo, load_mask, jax_zoo,
                                        jax_load_mask, fetch_script):
        yield root, base


def assert_tree_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], dict):
            assert_tree_equal(got[k], want[k])
        else:
            assert torch.equal(got[k], want[k]), k


def tiny_models(monkeypatch):
    """Both zoos build stylegan2_tiny.npz's model (style_dim 64, two
    mapping layers) where they build the published 512-d one."""
    def tiny(cls):
        def build(size, style_dim, n_mlp, **kw):
            return cls(size=size, style_dim=STYLE_DIM, n_mlp=N_MLP, **kw)
        return build
    monkeypatch.setattr(zoo, "SeqStyleGAN2", tiny(SeqStyleGAN2))
    monkeypatch.setattr(jax_zoo.stylegan2_mod, "SeqStyleGAN2",
                        tiny(JaxSeqStyleGAN2))


def _golden_sd(g, prefix="sd."):
    return {k[len(prefix):]: torch.from_numpy(np.array(g[k]))
            for k in g.files if k.startswith(prefix)}


def test_both_zoos_download_the_tiny_stylegan2(server, goldens, tmp_path,
                                               monkeypatch):
    """stylegan2_tiny.npz as a rosinality file (``{"g_ema": ...,
    "latent_avg": ...}``, the stage names both converters read) on the
    server: each zoo downloads it into its empty weights directory, both
    files are the served one byte for byte, and the params are equal."""
    sd = _golden_sd(goldens("stylegan2_tiny"))
    latent_avg = sd.pop("latents.latent_avg")
    src = served_path(server, zoo.STYLEGAN2_URL + "stylegan2_church.pt")
    torch.save({"g_ema": sd, "latent_avg": latent_avg}, src)
    tiny_models(monkeypatch)
    monkeypatch.setenv("REWRITING_TPU_WEIGHTS", str(tmp_path / "jax"))
    jm, jp = jax_zoo.load_seq_stylegan("church", truncation=0.5, size=SIZE)
    monkeypatch.setenv("REWRITING_TPU_WEIGHTS", str(tmp_path / "port"))
    model, params = zoo.load_seq_stylegan("church", truncation=0.5,
                                          size=SIZE, device="cpu")
    want = src.read_bytes()
    for side in ("jax", "port"):
        assert (tmp_path / side / "stylegan2_church.pt").read_bytes() == want
        assert sorted(os.listdir(tmp_path / side)) == ["stylegan2_church.pt"]
    assert_tree_equal(params, params_from_jax(
        model, jax.tree_util.tree_map(np.asarray, jp)))


def test_both_zoos_download_the_tiny_proggan(server, goldens, tmp_path,
                                             monkeypatch):
    """proggan_tiny.npz as a gandissect file (a bare state dict in the old
    ``features.N`` names, the legacy serialization) on the server: both
    zoos download it byte for byte and load equal params."""
    pg_sd = _golden_sd(goldens("proggan_tiny"))
    model, params = zoo.proggan.from_state_dict(pg_sd, device="cpu")
    src = served_path(server, zoo.PROGGAN_URL + zoo.PROGGAN_ZOO["church"])
    torch.save(chip_smoke.proggan_checkpoint(model, params), src,
               _use_new_zipfile_serialization=False)
    monkeypatch.setenv("REWRITING_TPU_WEIGHTS", str(tmp_path / "jax"))
    jm, jp = jax_zoo.load_proggan("church")
    monkeypatch.setenv("REWRITING_TPU_WEIGHTS", str(tmp_path / "port"))
    got_model, got = zoo.load_proggan("church", device="cpu")
    for side in ("jax", "port"):
        assert (tmp_path / side / zoo.PROGGAN_ZOO["church"]).read_bytes() == \
            src.read_bytes()
    assert got_model.sizes == jm.sizes == model.sizes
    assert_tree_equal(got, params)
    assert_tree_equal(got, params_from_jax(
        got_model, jax.tree_util.tree_map(np.asarray, jp)))


def test_both_mask_registries_download_dome2tree(server, tmp_path,
                                                 monkeypatch):
    """dome2tree.json served compact: both registries write it as
    ``json.dump(..., indent=1)`` of the response, the same bytes (here the
    repo's file, which is that dump)."""
    with open(chip_smoke.MASK) as f:
        request = json.load(f)
    served_path(server, load_mask.MASK_URLS + "dome2tree.json").write_text(
        json.dumps(request, separators=(",", ":")))
    got = {}
    for side, registry in (("jax", jax_load_mask), ("port", load_mask)):
        monkeypatch.setenv("REWRITING_TPU_MASKS", str(tmp_path / side))
        path, dataset, layer = registry.load_mask_info("dome2tree")
        assert (dataset, layer) == ("church", 8)
        assert path == str(tmp_path / side / "church" / "dome2tree.json")
        got[side] = pathlib.Path(path).read_bytes()
        assert os.listdir(tmp_path / side / "church") == ["dome2tree.json"]
    assert got["port"] == got["jax"] == \
        pathlib.Path(chip_smoke.MASK).read_bytes()
    assert load_mask.load_mask_request("dome2tree") == request


class _Truncating(http.server.BaseHTTPRequestHandler):
    """Promises 1000 bytes, sends 10, closes."""

    def do_GET(self):
        self.send_response(200)
        self.send_header("Content-Length", "1000")
        self.end_headers()
        self.wfile.write(b"{\"paste\": ")

    def log_message(self, *args):
        pass


@contextlib.contextmanager
def failing_url(kind, root):
    """A base URL whose every fetch fails the `kind` way."""
    if kind == "404":
        with chip_smoke.loopback_server(str(root)) as base:
            yield base
    elif kind == "closed":
        yield chip_smoke.closed_url()
    elif kind == "silent":      # accepts the connection, never answers
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            s.listen(8)
            yield f"http://127.0.0.1:{s.getsockname()[1]}/"
    else:
        server = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                 _Truncating)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            yield f"http://127.0.0.1:{server.server_address[1]}/"
        finally:
            server.shutdown()
            server.server_close()
            thread.join()


@pytest.mark.parametrize("registry", ["zoo", "masks"])
@pytest.mark.parametrize("kind", ["404", "closed", "silent", "truncated"])
def test_failed_download_names_the_url(kind, registry, tmp_path,
                                       monkeypatch):
    """Each failure raises FileNotFoundError naming the file and its URL
    well within the timeout (patched to 1 s for the server that never
    answers), and leaves no ``.tmp`` and no file."""
    monkeypatch.setattr(download, "TIMEOUT", 1.0)
    (tmp_path / "served").mkdir()
    weights, masks = tmp_path / "weights", tmp_path / "masks"
    monkeypatch.setenv("REWRITING_TPU_WEIGHTS", str(weights))
    monkeypatch.setenv("REWRITING_TPU_MASKS", str(masks))
    with failing_url(kind, tmp_path / "served") as base:
        if registry == "zoo":
            monkeypatch.setattr(zoo, "PROGGAN_URL", base)
            name, url = zoo.PROGGAN_ZOO["kitchen"], base + \
                zoo.PROGGAN_ZOO["kitchen"]

            def call():
                return zoo.load_proggan("kitchen", device="cpu")
        else:
            monkeypatch.setattr(load_mask, "MASK_URLS", base)
            name, url = "dome2spire.json", base + "dome2spire.json"

            def call():
                return load_mask.load_mask_info("dome2spire")
        t0 = time.time()
        with pytest.raises(FileNotFoundError, match=name) as err:
            call()
        assert time.time() - t0 < FAIL_WITHIN
    assert url in str(err.value)
    left = [p for p in tmp_path.rglob("*") if p.is_file()]
    assert left == [], left


@pytest.fixture
def fetch_dirs(tmp_path, monkeypatch):
    weights, masks = tmp_path / "weights", tmp_path / "masks"
    monkeypatch.setenv("REWRITING_TPU_WEIGHTS", str(weights))
    monkeypatch.setenv("REWRITING_TPU_MASKS", str(masks))
    return weights, masks


def run_fetch(capsys, *groups):
    """(exit code, the summary line, stderr) of the fetch script."""
    rc = fetch_script.main(["--only", *groups])
    printed = capsys.readouterr()
    return rc, json.loads(printed.out.splitlines()[-1]), printed.err


def test_fetch_script_fetches_and_skips(server, fetch_dirs, capsys):
    """``main(["--only", ...])`` fetches each file of its groups from the
    server, byte for byte, into the place the port's readers look; a
    second run fetches nothing; a group the server lacks a file of is
    reported (exit 1), the rest fetched, no ``.tmp`` left."""
    weights, masks = fetch_dirs
    groups = ("face", "fid", "slimnet", "upp", "masks")
    rng = np.random.RandomState(0)
    for url, _ in fetch_script.plan(groups):
        served_path(server, url).write_bytes(rng.bytes(1000 + rng.randint(99)))
    plan = fetch_script.plan(groups)
    assert len(plan) == 10
    assert run_fetch(capsys, *groups)[:2] == (0, {
        "fetched": 10, "have": 0, "failed": 0, "weights": str(weights),
        "masks": str(masks)})
    for url, dest in plan:
        assert pathlib.Path(dest).read_bytes() == \
            served_path(server, url).read_bytes()
    # where the port's readers look
    dests = {pathlib.Path(d).relative_to(weights).as_posix()
             for _, d in plan if d.startswith(str(weights))}
    assert {fid.WEIGHTS_FILENAME, slimnet.WEIGHTS_FILENAME,
            faceparse.WEIGHTS_FILENAME, "upp/encoder_epoch_40.pth",
            "upp/decoder_epoch_40.pth", "upp/labels.json"} == dests
    for name in load_mask.name2info:
        assert (url_dest := load_mask.load_mask_info(name)[0]) in \
            [d for _, d in plan], url_dest
    rc, summary, _ = run_fetch(capsys, *groups)
    assert (rc, summary["fetched"], summary["have"]) == (0, 0, 10)
    # the vgg file is not on the server: reported, the rest still fetched
    (weights / fid.WEIGHTS_FILENAME).unlink()
    rc, summary, err = run_fetch(capsys, "vgg", "fid")
    assert (rc, summary["fetched"], summary["failed"]) == (1, 1, 1)
    assert f"FAILED {fetch_script.VGG16_URL}" in err
    assert not list(weights.rglob("*.tmp"))
    assert not (weights / "vgg16_features.pth").exists()


def test_fetch_script_plan_is_the_jax_scripts(monkeypatch, tmp_path):
    """Every group's URLs are the JAX script's (``scripts/fetch_weights.py``,
    read without running it) and the zoo's and registry's; the files land
    where the port's readers look: VGG16 under the name ``distances``
    reads, the masks in ``$REWRITING_TPU_MASKS/<dataset>/``."""
    tree = ast.parse((ROOT / "scripts" / "fetch_weights.py").read_text())
    jax_script = {t.id: ast.literal_eval(node.value) for node in tree.body
                  if isinstance(node, ast.Assign) for t in node.targets
                  if isinstance(t, ast.Name) and t.id.isupper()}
    for name in ("UPP_BASE", "UPP_FILES", "FACE_URL", "FID_INCEPTION_URL",
                 "VGG16_URL", "SLIMNET_URL"):
        assert getattr(fetch_script, name) == jax_script[name], name
    assert load_mask.MASK_URLS == jax_script["MASKS_URL"] == \
        jax_load_mask.MASK_URLS
    assert sorted(n for _, n, _ in load_mask.name2info.values()) == \
        sorted(jax_script["MASK_FILES"])
    for name in ("STYLEGAN2_URL", "STYLEGAN2_ZOO", "PROGGAN_URL",
                 "PROGGAN_ZOO"):
        assert getattr(zoo, name) == getattr(jax_zoo, name), name
    assert fetch_script.GROUPS == ("stylegan2", "proggan", "upp", "face",
                                   "fid", "vgg", "slimnet", "masks")
    monkeypatch.setenv("REWRITING_TPU_WEIGHTS", str(tmp_path / "w"))
    monkeypatch.setenv("REWRITING_TPU_MASKS", str(tmp_path / "m"))
    plan = dict(fetch_script.plan(fetch_script.GROUPS))
    assert len(plan) == 8 + 8 + 3 + 1 + 1 + 1 + 1 + 4
    vgg = pathlib.Path(plan[jax_script["VGG16_URL"]])
    assert vgg == tmp_path / "w" / "vgg16_features.pth"
    # LPIPS reads torchvision's VGG16 (classifier included) from there
    rng = np.random.RandomState(1)
    sd = {f"features.{i}.{k}": torch.from_numpy(rng.randn(2).astype(
        np.float32)) for i in range(29) for k in ("weight", "bias")}
    sd["classifier.0.weight"] = torch.zeros(2, 2)
    vgg.parent.mkdir(parents=True)
    torch.save(sd, vgg, _use_new_zipfile_serialization=False)
    convs = distances.default_lpips_params()["convs"]
    assert torch.equal(convs[0]["weight"], sd["features.0.weight"])
    assert torch.equal(convs[-1]["bias"], sd["features.28.bias"])
    assert plan[load_mask.MASK_URLS + "smile.json"] == str(
        tmp_path / "m" / "faces" / "smile.json")
    for name, (filename, _) in zoo.STYLEGAN2_ZOO.items():
        assert plan[zoo.STYLEGAN2_URL + filename] == str(tmp_path / "w" /
                                                         filename)


# -- the gated suite and its runbook -------------------------------------

def test_real_weights_suite_mirrors_the_jax_suite():
    """One counterpart per test function of tests/test_real_weights.py, in
    its order, with its parametrisation, and each in the runbook's
    table of the artifacts it needs."""
    def tests(path):
        tree = ast.parse(path.read_text())
        out = {}
        for node in tree.body:
            if isinstance(node, ast.FunctionDef) and \
                    node.name.startswith("test_"):
                out[node.name] = [ast.unparse(d) for d in node.decorator_list
                                  if "parametrize" in ast.unparse(d)]
        return out
    jax_tests = tests(ROOT / "tests" / "test_real_weights.py")
    port_tests = tests(ROOT / "tests" / "test_torch_real_weights.py")
    assert len(jax_tests) == 11
    assert list(port_tests) == list(jax_tests)
    assert port_tests == jax_tests
    assert set(report_script.NEEDS) == set(port_tests)
    assert set().union(*report_script.NEEDS.values()) <= \
        set(report_script.artifacts())


def run_report(tmp_path, weights):
    env = dict(os.environ, REWRITING_TPU_WEIGHTS=str(weights),
               REWRITING_TPU_MASKS=str(tmp_path / "masks"))
    proc = subprocess.run([sys.executable, str(ROOT / "scripts" /
                                                "torch_real_weights_report.py"
                                                )], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=600)
    lines = [json.loads(line) for line in proc.stdout.splitlines()
             if line.startswith("{")]
    return proc, lines


def test_report_skips_every_test_naming_its_file(tmp_path):
    """With no published file, the runbook lists every artifact missing
    and the suite's 25 tests skipped, each naming its missing file; it
    exits 0."""
    weights = tmp_path / "weights"
    weights.mkdir()
    proc, lines = run_report(tmp_path, weights)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert lines[-1]["passed"] == lines[-1]["failed"] == 0
    assert lines[-1]["skipped"] == 25
    assert [r["artifact"] for r in lines[:-1]] == \
        list(report_script.artifacts())
    assert all(r["present"] == 0 for r in lines[:-1])
    reasons = [line for line in proc.stdout.splitlines()
               if line.startswith("SKIPPED")]
    assert len(reasons) == 25
    files = [os.path.basename(f) for fs in report_script.artifacts().values()
             for f in fs]
    assert all(any(f in r for f in files) for r in reasons), reasons


def test_report_fails_on_a_bad_file(tmp_path):
    """A published name holding a file the port cannot read fails its
    tests (not a skip), and the runbook exits 1."""
    weights = tmp_path / "weights"
    weights.mkdir()
    (weights / "stylegan2_church.pt").write_bytes(b"not a checkpoint")
    proc, lines = run_report(tmp_path, weights)
    assert proc.returncode == 1
    church = next(r for r in lines if r.get("artifact") == "stylegan2 zoo")
    assert church["present"] == 1 and church["failed"] >= 1
    assert lines[-1]["failed"] >= 1


def test_phase41_on_the_cpu(tmp_path):
    """``chip_smoke.check_downloads`` on the CPU at 8 px: phase 12's and
    15's files written small, stand-ins for phase 25's; every check holds
    and nothing launches (the plain versions run)."""
    model = SeqStyleGAN2(8, style_dim=512, n_mlp=8, device="cpu")
    params = model.init_params(seed=0)
    params["latents"] = {"latent_avg": torch.zeros(512)}
    checkpoint = tmp_path / "stylegan2_church.pt"
    torch.save(chip_smoke.rosinality_checkpoint(model, params), checkpoint)
    pg = ProgressiveGenerator(sizes=[512, 16, 16, 8], device="cpu")
    proggan = tmp_path / "proggan_churchoutdoor.pth"
    torch.save(chip_smoke.proggan_checkpoint(pg, pg.init_params(seed=0)),
               proggan)
    weights = tmp_path / "weights"
    with chip_smoke.weights_env(str(weights)):
        for _, dest in fetch_script.plan(chip_smoke.FETCH_GROUPS):
            pathlib.Path(dest).parent.mkdir(parents=True, exist_ok=True)
            pathlib.Path(dest).write_bytes(os.urandom(4096))
    out = chip_smoke.check_downloads(str(checkpoint), str(proggan),
                                     str(weights), device="cpu", size=8,
                                     nz=2)
    assert not any(out["launches"].values())
    assert [r["fetched"] for r in out["fetch_runs"]] == [6, 0]
    assert out["stylegan2_bytes"] == checkpoint.stat().st_size
    kernels = {name: {} for name in ("blur2d", "upconv_blur",
                                     "upconv_blur_bf16", "upsample2x")}
    chip_smoke.add_slice19(kernels, out)
    assert all(k["download_launches"] == 0 for k in kernels.values())


def test_phase41_needs_cuda_unless_told(monkeypatch, tmp_path, capsys):
    """Phase 41's check runs on the card unless given ``device="cpu"``,
    and ``scripts/smoke_slice19.py`` exits non-zero without CUDA."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chip_smoke.check_downloads(str(tmp_path / "a.pt"),
                                   str(tmp_path / "b.pth"), str(tmp_path))
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        import smoke_slice19
    finally:
        sys.path.remove(str(ROOT / "scripts"))
    assert smoke_slice19.main() != 0
    assert "no CUDA device" in capsys.readouterr().err
