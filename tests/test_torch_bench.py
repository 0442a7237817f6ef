"""The port's measurement entry points: ``galaxy_deconv_tpu_torch/bench.py``
and ``cli bench`` (counterparts of ``bench.py`` and the JAX ``cli bench``),
the FLOP and byte counts behind ``scripts/mfu_torch.py``, the input-pipeline
probe ``scripts/bench_pipeline_torch.py`` and the two ``_torch`` tutorials.

The bench's stamps equal ``bench.py``'s byte for byte; its pipeline at a
small width with flax's weights gives JAX's shear rows at the pipeline
tolerance of tests/test_torch_model.py; the FLOP count equals the count from
the layers' shapes and is set against XLA's ``cost_analysis``; every entry
point runs on the CPU with jax, flax, orbax and the JAX package blocked
(tests/test_torch_port_rules.py's blocker).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from galaxy_deconv_tpu.metrics import estimate_shear as jestimate_shear
from galaxy_deconv_tpu.models.unrolled_admm_gaussian import UnrolledADMMGaussian as JModel
from galaxy_deconv_tpu.nets import ResUNet as JResUNet
from galaxy_deconv_tpu_torch import bench, cli
from galaxy_deconv_tpu_torch.models import UnrolledADMMGaussian
from galaxy_deconv_tpu_torch.nets import ResUNet
from galaxy_deconv_tpu_torch.pipeline import build_pipeline
from galaxy_deconv_tpu_torch.train import create_train_state
from galaxy_deconv_tpu_torch.train.checkpoint import save_checkpoint
from galaxy_deconv_tpu_torch.utils import flops, model_state_dict
from test_torch_port_rules import ENV, run_blocked
from test_torch_zoo import jit, variables

SMALL = {"n_iters": 2, "features": (4, 8, 16, 32)}
RTOL, ATOL = 1e-4, 1e-5  # tests/test_torch_model.py's shear tolerance for the pipeline
PSF_RTOL = 2e-6  # the rounding of a float32 sum of 2,304 positive pixels in two orders: ~sqrt(2304) ulps
ENV2 = {**ENV, "OMP_NUM_THREADS": "2"}  # the full-width nets' CPU work, on cores the other test workers share
# The flagship's FLOPs per galaxy at full width: 9,992,503,296 in its
# convolutions (8 ResUNets 9,986,899,968, the SubNet the rest) and 140,416 in
# the SubNet's dense layers.
FLAGSHIP_FLOPS_PER_GALAXY = 9_992_643_712


def test_bench_stamps_equal_bench_py():
    """bench.py:55-60, built here as it builds them.  obs and alpha equal
    bench.py's byte for byte.  bench.py normalises the PSFs on the JAX
    device, where XLA sums each stamp's 2,304 pixels in another order than
    numpy's pairwise sum, so the normalised PSFs differ by the rounding of
    those sums: every element, by at most 9 float32 ulps (5.4e-7 relative)
    on the CPU at B = 256, held at PSF_RTOL."""
    for B in (3, 256):
        rng = np.random.default_rng(0)
        obs = jnp.asarray(np.abs(rng.standard_normal((B, 48, 48))).astype(np.float32) * 20)
        psf = jnp.asarray(np.abs(rng.standard_normal((B, 48, 48))).astype(np.float32))
        psf = psf / psf.sum(axis=(1, 2), keepdims=True) / 16.0
        alpha = jnp.asarray(np.full((B,), 50.0, np.float32))
        got = bench.bench_inputs(B)
        for g, w in zip(got, (obs, psf, alpha)):
            assert g.dtype == np.float32 and g.shape == w.shape
        assert got[0].tobytes() == np.asarray(obs).tobytes() and got[2].tobytes() == np.asarray(alpha).tobytes()
        np.testing.assert_allclose(got[1], np.asarray(psf), rtol=PSF_RTOL, atol=0)


def test_bench_record_schema():
    rec = bench.record(1234.56)
    assert list(rec) == ["metric", "value", "unit", "vs_baseline"]
    assert rec == {"metric": "galaxies_per_sec_per_chip_admm8", "value": 1234.6, "unit": "gal/s/chip",
                   "vs_baseline": round(1234.56 * 0.0590, 1)}


def test_bench_pipeline_shear_rows_match_jax():
    """The bench's pipeline at a small width with flax's weights (flax's tree
    filled from numpy, as tests/test_torch_zoo.py fills it: an un-jitted
    ``init`` takes ~25 s on the CPU) against JAX's jitted pipeline on 8 of
    bench.py's stamps: the last timed call's (B, 3) rows."""
    obs, psf, alpha = bench.bench_inputs(8)
    jm = JModel(**SMALL, fft_impl="xla")
    v = variables(jm, obs[:1], psf[:1], alpha[:1])
    want = np.asarray(jit(lambda o, p, a: jestimate_shear(jm.apply(v, o, p, a)))(obs, psf, alpha))
    pipe = build_pipeline("cpu", state_dict=model_state_dict(v["params"], v["batch_stats"]), **SMALL)
    seconds, got = bench.timed_run(pipe, (obs, psf, alpha), repeats=2)
    assert seconds > 0 and got.shape == (8, 3) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_timed_run_needs_a_repeat():
    with pytest.raises(ValueError, match="repeats"):
        bench.timed_run(bench.bench_pipeline("float32", "cpu", **SMALL), bench.bench_inputs(1), 0)


def test_bench_and_mfu_raise_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["bench", "--batch_size", "2", "--repeats", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.mfu_report(batch=1, gal_per_sec=1.0)


# --- FLOP counts -------------------------------------------------------------------


def _valid_taps(n_in: int, k: int, stride: int, pad: int) -> int:
    """(output position, kernel tap) pairs along one axis whose input index
    falls inside the unpadded input."""
    n_out = (n_in + 2 * pad - k) // stride + 1
    return sum(0 <= o * stride - pad + t < n_in for o in range(n_out) for t in range(k))


def valid_tap_flops(model: nn.Module, x: torch.Tensor) -> int:
    """FLOPs of ``model``'s convolutions counting only taps inside the
    unpadded input, as XLA's cost analysis counts a padded convolution (a
    stride-2 2x2 transposed convolution has one valid tap per output pixel
    and axis: no padding is skipped)."""
    total = 0

    def hook(mod, inputs, output):
        nonlocal total
        x = inputs[0]
        if isinstance(mod, nn.ConvTranspose2d):
            total += 2 * x.shape[0] * mod.in_channels * mod.out_channels * 4 * x.shape[2] * x.shape[3]
            return
        k, s, p = mod.kernel_size[0], mod.stride[0], mod.padding[0]
        total += (2 * x.shape[0] * mod.in_channels * mod.out_channels * _valid_taps(x.shape[2], k, s, p)
                  * _valid_taps(x.shape[3], k, s, p))

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))]
    with torch.no_grad():
        model(x)
    for h in handles:
        h.remove()
    return total


def test_flop_count_equals_analytic_count_and_sits_against_xla():
    """FlopCounterMode's count of the small-width pipeline and of its ResUNet
    equals the count from the layers' shapes.  XLA's cost analysis of the
    flax ResUNet at that width reads below it, 0.928 of it on the CPU: XLA
    counts only the taps of a padded 3x3 convolution that land inside the
    unpadded input (3H - 2 of the 3H pairs along an axis of H pixels), and
    then adds its elementwise work, one FLOP per element (ReLUs, residual
    adds): 8.28e-3 of the valid-tap count at this width."""
    obs, psf, alpha = (torch.from_numpy(a) for a in bench.bench_inputs(2))
    pipe = bench.bench_pipeline("float32", "cpu", **SMALL)
    counts = flops.measure(pipe.model, pipe, obs, psf, alpha)
    assert counts.flops == counts.analytic_flops > counts.analytic_flops_in("resunet") > 0
    assert set(counts.flops_by_op) == {"aten.convolution", "aten.addmm"}
    assert counts.bytes > 0

    x = torch.from_numpy(obs.numpy()[:, None])
    net = ResUNet(features=SMALL["features"]).eval()
    with torch.no_grad():
        net_counts = flops.measure(net, net, x)
    net_counted = net_counts.flops
    assert net_counted == net_counts.analytic_flops
    assert counts.analytic_flops_in("resunet") == SMALL["n_iters"] * net_counted
    valid = valid_tap_flops(net, x)
    dn = JResUNet(features=SMALL["features"])
    xj = jnp.asarray(x.numpy().transpose(0, 2, 3, 1))
    cost = jax.jit(dn.apply).lower(jax.eval_shape(dn.init, jax.random.PRNGKey(0), xj), xj).compile().cost_analysis()
    xla = float((cost[0] if isinstance(cost, (list, tuple)) else cost)["flops"])
    assert valid <= xla <= valid * (1 + 1e-2)
    assert 0.9 <= xla / net_counted <= 0.95


# --- entry points with JAX blocked ---------------------------------------------------------


def _last_json(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cli_bench_runs_without_jax(dtype):
    """``python -m galaxy_deconv_tpu_torch bench --device cpu --batch_size 4
    --repeats 1``: bench.py's line, last; the device on stderr."""
    body = f"""
import runpy, sys
sys.argv = ["galaxy_deconv_tpu_torch", "bench", "--device", "cpu", "--batch_size", "4", "--repeats", "1",
            "--dtype", {dtype!r}]
runpy.run_module("galaxy_deconv_tpu_torch", run_name="__main__", alter_sys=True)
"""
    res = run_blocked(body, env=ENV2)
    assert res.returncode == 0, res.stderr
    rec = _last_json(res.stdout)
    assert list(rec) == ["metric", "value", "unit", "vs_baseline"]
    assert rec["metric"] == "galaxies_per_sec_per_chip_admm8" and rec["unit"] == "gal/s/chip"
    # vs_baseline comes from the unrounded rate
    assert rec["value"] > 0 and abs(rec["vs_baseline"] - rec["value"] * 0.0590) <= 0.05 + 0.05 * 0.0590
    assert "device: cpu" in res.stderr and "1 x 4 galaxies" in res.stderr


def test_mfu_script_runs_without_jax():
    body = """
import runpy, sys
sys.argv = ["mfu_torch.py", "--cpu-flops", "--gal_per_sec", "1", "--batch", "1"]
runpy.run_path("scripts/mfu_torch.py", run_name="__main__")
"""
    res = run_blocked(body, env=ENV2)
    assert res.returncode == 0, res.stderr
    report = json.loads(res.stdout)
    assert report["conv_matmul_flops_per_galaxy"] == report["analytic_flops_per_galaxy"] == FLAGSHIP_FLOPS_PER_GALAXY
    assert report["flops_per_galaxy_by_op"] == {"aten.convolution": 9_992_503_296, "aten.addmm": 140_416}
    assert report["conv_flops_per_galaxy_8xResUNet"] == 9_986_899_968
    assert report["throughput_source"] == "supplied" and report["device"] == "cpu"
    assert report["peak_tflops_dtype_matched"] == 989.4 and report["h100_roofline_knee_flop_per_byte"] == 295.3
    assert report["mfu_vs_dtype_peak"] == round(FLAGSHIP_FLOPS_PER_GALAXY / 989.4e12, 4)
    assert report["bytes_accessed_unfused_per_galaxy"] > 0


def test_mfu_script_refuses_cpu_without_throughput():
    res = run_blocked('import runpy, sys\nsys.argv = ["mfu_torch.py", "--cpu-flops"]\n'
                      'runpy.run_path("scripts/mfu_torch.py", run_name="__main__")', env=ENV2)
    assert res.returncode == 2 and "--cpu-flops requires --gal_per_sec" in res.stderr


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A small Deconv tree from ``cli generate`` (16-sample pupil)."""
    root = tmp_path_factory.mktemp("bench") / "data"
    cli.main(["generate", "--data_path", str(root), "--n_train", "8", "--n_test", "2", "--pupil_n", "16",
              "--chunk", "8", "--errs", "0.02", "--device", "cpu"])
    return root


def test_input_pipeline_probe_runs_without_jax(tree):
    body = f"""
import runpy, sys
sys.argv = ["bench_pipeline_torch.py", "--device", "cpu", "--data", {str(tree)!r}, "--batches", "4", "--repeats", "1",
            "--passes", "2"]
runpy.run_path("scripts/bench_pipeline_torch.py", run_name="__main__")
"""
    res = run_blocked(body, env=ENV2)
    assert res.returncode == 0, res.stderr
    assert "simulate_batch B=4:" in res.stdout and "host clock" in res.stdout
    assert "dataset read B=4, 8 galaxies, 2 passes, gal/s median [least, most]: " in res.stdout


def test_tutorials_run_without_jax(tree, tmp_path):
    """The deconvolution tutorial on the tree's first test galaxy, with
    Richardson-Lucy (no checkpoint) and with a port checkpoint of the
    flagship (seed-0 weights); the simulation walkthrough with matplotlib and,
    with matplotlib blocked too, its .npz."""
    models = tmp_path / "models"
    state, _ = create_train_state(UnrolledADMMGaussian(n_iters=8), 0)
    save_checkpoint(models, "Gaussian_PnP_ADMM_8iters_MultiScale", 3, state)
    body = f"""
import importlib.abc, runpy, sys
import numpy as np
deconv = runpy.run_path("examples/deconv_single_image_torch.py")["main"]
for ckpt, method in (({str(tmp_path / "none")!r}, "Richardson-Lucy (30)"),
                     ({str(models)!r}, "Unrolled ADMM (8), Gaussian_PnP_ADMM_8iters_MultiScale epoch 3")):
    out = deconv(["--device", "cpu", "--data_path", {str(tree)!r}, "--checkpoint", ckpt])
    assert out["method"] == method, out["method"]
    assert out["rec"].shape == (48, 48) and np.isfinite(out["rec"]).all() and np.isfinite(out["g_rec"]).all()
walk = runpy.run_path("examples/simulation_walkthrough_torch.py")["main"]
out = walk(["--device", "cpu", "--out", {str(tmp_path / "walk.png")!r}])
assert out["out"].suffix == ".png" and out["out"].stat().st_size > 0
assert abs(out["snr"] - 100.0) < 1e-3 and all(np.isfinite(v).all() for v in out["panels"].values())

class NoMatplotlib(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "matplotlib":
            raise ImportError("blocked import of matplotlib")
sys.meta_path.insert(0, NoMatplotlib())
for name in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
    del sys.modules[name]
out = walk(["--device", "cpu", "--out", {str(tmp_path / "walk2.png")!r}])
assert out["out"].suffix == ".npz" and sorted(np.load(out["out"])) == sorted(k.replace(" ", "_") for k in out["panels"])
print("tutorials ok")
"""
    res = run_blocked(body, env=ENV2)
    assert res.returncode == 0, res.stderr
    assert "tutorials ok" in res.stdout and "psnr(rec, gt)" in res.stdout
    assert "matplotlib is not installed" in res.stdout

