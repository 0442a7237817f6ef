"""Port parity: data parallelism over torch.distributed (galaxy_deconv_tpu_torch/parallel)
against the JAX package's mesh path (galaxy_deconv_tpu/parallel) on the CPU.

Two ranks over gloo, each a subprocess started the way ``torchrun`` starts
one (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT in its environment), one
intra-op thread each, against JAX's ``make_mesh(2)`` on two of the CPU's
virtual devices, at narrow width (n_iters 2, features (8, 8, 16, 16)): three
train steps from the bridged state, ``fit`` over two epochs, the shear and
time sweeps, and every loss ``build_loss`` makes; then ``cli train`` and
``cli test`` under ``torchrun --nproc_per_node 2`` against the same commands
in one process.  Every rank's wait has its own timeout, so a hang fails the
test.  Each test states its tolerance."""

import datetime
import importlib.util
import json
import os
import pathlib
import re
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from galaxy_deconv_tpu.data import dataset as jdataset
from galaxy_deconv_tpu.eval import harness as J
from galaxy_deconv_tpu.losses import multiscale as jms
from galaxy_deconv_tpu.models.unrolled_admm_gaussian import UnrolledADMMGaussian as JModel
from galaxy_deconv_tpu.parallel import make_mesh as jmake_mesh
from galaxy_deconv_tpu.parallel import shard_batch as jshard_batch
from galaxy_deconv_tpu.train import checkpoint as jckpt
from galaxy_deconv_tpu.train.loop import fit as jfit
from galaxy_deconv_tpu.train.state import TrainState as JTrainState
from galaxy_deconv_tpu.train.state import default_optimizer as jdefault_optimizer
from galaxy_deconv_tpu_torch import cli
from galaxy_deconv_tpu_torch.eval import harness
from galaxy_deconv_tpu_torch.data import GalaxyDataset, iterate_batches, train_val_indices
from galaxy_deconv_tpu_torch.losses import build_loss
from galaxy_deconv_tpu_torch.parallel import Mesh, initialize_distributed, make_mesh, shard_batch
from galaxy_deconv_tpu_torch.train import restore_checkpoint
from galaxy_deconv_tpu_torch.utils.convert_flax import model_state_dict, train_state_payload

REPO = pathlib.Path(__file__).resolve().parent.parent
NARROW = dict(n_iters=2, features=(8, 8, 16, 16))
LR = 2e-4
RANK_TIMEOUT_S = 240  # each rank's wait; a hang fails the test, it does not eat the suite
LOSSES = ("MultiScale", "MSE", "Shape", "BestEllipse", "MomentBasedLoss")
SWEEP = ("No_Deconv", "FPFS", "Richard-Lucy(10)")  # against JAX's mesh sweep; the flagship against the bulk path
FLAGSHIP = ("Gaussian_PnP_ADMM_8iters_MultiScale", 7000)  # trained/, as tests/test_torch_eval.py sweeps it
SHEAR_TOL = 1e-5  # |g_port - g_jax| <= SHEAR_TOL * (1 + |g_jax|), as tests/test_torch_eval.py holds the sweeps
# The train steps' data: 16 of chip_smoke.py's galaxy stamps (elliptical Gaussian PSFs), numpy seed DATA_SEED.
# Two ranks sum the BatchNorm statistics in another order than one process, which moves every SubNet activation by
# float32 rounding (~5e-7 at its last layer), and a ReLU whose input lies that close to its kink takes its mask from
# rounding.  On noise PSFs (|N(0,1)|, numpy seed 41, tests/test_torch_train.py's batch) one activation sits at 5.3e-7
# (float64), one process puts it at +2.8e-8, the ranks' split sums at -2.3e-7, and the SubNet's gradient moves by
# 12.7% of a layer's largest entry: a comparison of two summation orders there reads rounding, not the port
# (CHANGES.md, PR 10).
DATA_SEED = 3

def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port), OMP_NUM_THREADS="1")
    return env


def start_ranks(body: str, *args, world: int = 2) -> list:
    """``world`` ranks of ``python -c body args...``, started, not waited for."""
    port = free_port()
    return [subprocess.Popen([sys.executable, "-c", body, *map(str, args)], cwd=REPO, env=rank_env(r, world, port),
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(world)]


def wait_ranks(procs: list, timeout: float = RANK_TIMEOUT_S) -> list[str]:
    """Each rank's stdout; a rank that fails or outlives ``timeout`` fails the
    test, with every rank killed."""
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"rank exited {p.returncode}:\n{err[-4000:]}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def torchrun(*argv, timeout: float = RANK_TIMEOUT_S) -> subprocess.CompletedProcess:
    """``torchrun --standalone --nproc_per_node 2 -m galaxy_deconv_tpu_torch argv...``."""
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "XLA_FLAGS")}
    res = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
                          "-m", "galaxy_deconv_tpu_torch", *map(str, argv)], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=timeout)
    assert res.returncode == 0, res.stderr[-4000:]
    return res


def zero_grad_param(name):
    """The SubNet's conv biases feed train-mode BatchNorm: exact gradient 0 (tests/test_torch_train.py)."""
    return re.fullmatch(r"subnet\.convs\.\d+\.conv\d\.bias", name) is not None


def params_close(got: torch.Tensor, want: torch.Tensor, steps: int) -> bool:
    """Parameters after ``steps`` Adam steps on two sides: at narrow width
    after up to 3 steps every entry within 0.02 lr, tests/test_torch_train.py's
    rule; after more steps, or at full width, where more entries have
    gradients near rounding noise (Adam moves such an entry by a whole lr
    either way), every entry within 2 lr per step and the mean entry within
    0.02 lr (``steps`` 0 takes the first rule)."""
    d = (got - want).abs()
    if steps == 0:
        return float(d.max()) <= 0.02 * LR
    return float(d.max()) <= 2 * steps * LR and float(d.mean()) <= 0.02 * LR


def as_np(tree):
    return jax.tree.map(np.array, tree)


def jax_state_payload(st):
    adam = st.opt_state[1][0]
    return train_state_payload(as_np(st.params), as_np(st.batch_stats), as_np(adam.mu), as_np(adam.nu),
                               adam.count, st.step)


def write_test_split(root: pathlib.Path, n: int, seed: int) -> pathlib.Path:
    """A packed dataset's test split with the fixed-SNR variant ``obs_100``
    (chip_smoke.py's numpy stamps)."""
    d = root / "test"
    d.mkdir(parents=True)
    for name, arr in chip_smoke().galaxy_stamps(n, seed).items():
        np.save(d / f"{name}.npy", arr)
        if name in ("obs", "gt"):
            np.save(d / f"{name}_100.npy", arr)
    (root / "info.json").write_text(json.dumps({"n_test": n, "seed": seed}))
    return root


# --- process groups, the mesh, sharding ------------------------------------------


def test_initialize_distributed_without_configuration_does_nothing(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    initialize_distributed("cpu")
    assert not dist.is_initialized()
    mesh = make_mesh(None, "cpu")
    assert (mesh.group, mesh.rank, mesh.world_size, mesh.device) == (None, 0, 1, torch.device("cpu"))


@pytest.mark.parametrize("kw", [
    {"init_method": "tcp://127.0.0.1:{port}"},  # incomplete: no rank or world size
    {"init_method": "tcp://127.0.0.1:{port}", "world_size": 2, "rank": 1, "timeout": datetime.timedelta(seconds=2)},
], ids=["incomplete", "no-peer"])
def test_initialize_distributed_raises_on_a_configuration_that_cannot_connect(kw):
    kw = {k: v.format(port=free_port()) if isinstance(v, str) else v for k, v in kw.items()}
    with pytest.raises((ValueError, RuntimeError)):
        initialize_distributed("cpu", **kw)
    assert not dist.is_initialized()


@pytest.mark.parametrize("n_devices,ok", [(None, True), (1, True), (2, False), (8, False)])
def test_make_mesh_accepts_only_the_world_size(n_devices, ok):
    if ok:
        assert make_mesh(n_devices, "cpu").world_size == 1
    else:
        with pytest.raises(ValueError, match=f"n_devices={n_devices}, but the process group has 1 rank"):
            make_mesh(n_devices, "cpu")


@pytest.mark.parametrize("n", [16, 15])
def test_shard_batch_matches_jax(n):
    # each rank's shard against the shard JAX's make_mesh(2) places on that
    # device, bit for bit; a batch that does not divide raises on both sides
    rng = np.random.default_rng(0)
    batch = {"obs": rng.standard_normal((n, 48, 48)).astype(np.float32),
             "alpha": rng.standard_normal((n,)).astype(np.float32)}
    meshes = [Mesh(None, r, 2, torch.device("cpu")) for r in range(2)]
    if n % 2:
        with pytest.raises(ValueError, match="divisible by 2"):
            jshard_batch(batch, jmake_mesh(2))
        for m in meshes:
            with pytest.raises(ValueError, match="does not divide over the 2 ranks"):
                shard_batch(batch, m)
        return
    placed = jshard_batch(batch, jmake_mesh(2))
    for r, m in enumerate(meshes):
        got = shard_batch(batch, m)
        for k, v in placed.items():
            shard = next(s for s in v.addressable_shards if s.device == jax.devices()[r])
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(shard.data), err_msg=k)


@pytest.mark.parametrize("count", [2, 3])
@pytest.mark.parametrize("shuffle", [False, True])
def test_iterate_batches_process_split_matches_jax(tmp_path, count, shuffle):
    root = chip_smoke().write_dataset(tmp_path / "data", n=23, seed=2)
    ds, jds = GalaxyDataset(root), jdataset.GalaxyDataset(root)
    for index in range(count):
        got = list(iterate_batches(ds, 3, shuffle=shuffle, seed=5, process_index=index, process_count=count,
                                   drop_last=False))
        want = list(jdataset.iterate_batches(jds, 3, shuffle=shuffle, seed=5, process_index=index,
                                             process_count=count, drop_last=False))
        assert len(got) == len(want) > 0
        for b, jb in zip(got, want):
            for k in jb:
                np.testing.assert_array_equal(b[k], jb[k], err_msg=k)


# --- two gloo ranks against JAX's mesh ---------------------------------------------

RANK_BODY = r"""
import copy, json, pathlib, sys
import numpy as np, torch
torch.set_num_threads(1)
from galaxy_deconv_tpu_torch.data import GalaxyDataset
from galaxy_deconv_tpu_torch.eval import harness
from galaxy_deconv_tpu_torch.losses import MultiScaleLoss, build_loss
from galaxy_deconv_tpu_torch.models import UnrolledADMMGaussian
from galaxy_deconv_tpu_torch.parallel import global_batch, initialize_distributed, make_mesh, shard_rows
from galaxy_deconv_tpu_torch.train import TrainState, default_optimizer, fit, loop
from galaxy_deconv_tpu_torch.train.checkpoint import load_payload, state_payload

work = pathlib.Path(sys.argv[1])
initialize_distributed("cpu")
mesh = make_mesh(2, "cpu")
out = {"losses": [], "states": []}

# fit, two epochs, each train step's loss and state recorded
make = loop.make_train_step
def recorded(*args, **kwargs):
    step = make(*args, **kwargs)
    def run(state, batch):
        state, loss = step(state, batch)
        out["losses"].append(float(loss))
        out["states"].append(copy.deepcopy(state_payload(state)))
        return state, loss
    return run
loop.make_train_step = recorded
model = UnrolledADMMGaussian(n_iters=2, features=(8, 8, 16, 16))
state = load_payload(TrainState(0, model, default_optimizer().init(model)), torch.load(work / "state0.pt"))
_, out["history"] = fit(model, state, default_optimizer(), MultiScaleLoss(), GalaxyDataset(work / "train"), n_epochs=2,
                        batch_size=4, train_val_split=0.75, seed=3, model_name="run", save_path=str(work / "fit_port"),
                        mesh=mesh, stall_timeout_s=None)

# every loss of build_loss: the value and the gradient w.r.t. the reconstruction on this rank's shard
pair = dict(np.load(work / "loss_pair.npz"))
rows = shard_rows(pair["gt"].shape[0], mesh)
out["loss_values"], out["loss_grads"] = {}, {}
for name in sys.argv[2].split(","):
    rec = torch.from_numpy(pair["rec"][rows]).requires_grad_()
    with global_batch(mesh.group):
        value = build_loss(name)(torch.from_numpy(pair["gt"][rows]), rec)
    value.backward()
    out["loss_values"][name], out["loss_grads"][name] = float(value), rec.grad

# the shear sweeps of the mesh path (the trained flagship's too), and the time sweep
for method in sys.argv[3].split(","):
    out[method] = harness.run_shear_test(method, work / "eval", work / "sweep_port", snrs=(100,), n_gal=10,
                                         batch_size=4, device="cpu", mesh=mesh)
out["flagship"] = harness.run_shear_test("Unrolled_ADMM_Gaussian(8)", work / "eval", work / "sweep_port", snrs=(100,),
                                         n_gal=5, batch_size=4, device="cpu", mesh=mesh,
                                         state_dict=torch.load(work / "flagship.pt"))
harness.run_time_test("No_Deconv", work / "eval", work / "sweep_port", n_gal=10, batch_size=4, warmup=1, repeats=2,
                      mesh=mesh)
out["time"] = json.loads((work / "sweep_port" / "No_Deconv" / "results.json").read_text())["time"]
torch.save(out, work / f"rank{mesh.rank}.pt")
"""


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, monkeypatch_module):
    """The two ranks' records (started first), beside JAX's runs of the same
    work on make_mesh(2) (made while the ranks run): ``fit`` for two epochs,
    each train step's global batch, loss and state recorded on both sides."""
    import galaxy_deconv_tpu.train.loop as jloop

    work = tmp_path_factory.mktemp("parallel")
    cs = chip_smoke()
    cs.write_dataset(work / "train", n=16, seed=DATA_SEED)
    write_test_split(work / "eval", n=10, seed=5)
    b = jdataset.GalaxyDataset(work / "train").batch(np.arange(4))
    jmodel = JModel(**NARROW, fft_impl="xla")
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), b["obs"], b["psf"], b["alpha"])
    jopt = jdefault_optimizer()
    jstate = JTrainState(step=jax.numpy.zeros((), jax.numpy.int32), params=variables["params"],
                         batch_stats=variables["batch_stats"], opt_state=jopt.init(variables["params"]))
    torch.save(jax_state_payload(jstate), work / "state0.pt")
    trained = jax.tree.map(np.asarray, jckpt.unpack_variables(jckpt.restore_checkpoint(REPO / "trained", *FLAGSHIP)))
    torch.save(model_state_dict(trained["params"], trained["batch_stats"]), work / "flagship.pt")
    rng = np.random.default_rng(41)
    gt = np.abs(rng.standard_normal((4, 48, 48))).astype(np.float32) * rng.uniform(0.5, 5, (4, 1, 1)).astype(
        np.float32)
    np.savez(work / "loss_pair.npz", gt=gt, rec=(gt + 0.3 * rng.standard_normal(gt.shape)).astype(np.float32))
    procs = start_ranks(RANK_BODY, work, ",".join(LOSSES), ",".join(SWEEP))
    try:
        steps = []  # JAX's train steps in fit: (loss, state after)
        make = jloop.make_train_step

        def recorded(*args, **kwargs):
            step = make(*args, **kwargs)

            def run(state, batch):
                state, loss = step(state, batch)
                steps.append((float(loss), jax_state_payload(state)))
                return state, loss

            return run

        monkeypatch_module.setattr(jloop, "make_train_step", recorded)
        mesh = jmake_mesh(2)
        _, jhist = jfit(jmodel, jstate, jopt, jms.MultiScaleLoss(), jdataset.GalaxyDataset(work / "train"),
                        n_epochs=2, batch_size=4, train_val_split=0.75, seed=3, model_name="run",
                        save_path=str(work / "fit_jax"), mesh=mesh, stall_timeout_s=None)
        jsweep = {method: J.run_shear_test(method, work / "eval", work / "sweep_jax", snrs=(100,), n_gal=10,
                                           batch_size=4, mesh=mesh) for method in SWEEP}
    finally:
        wait_ranks(procs)
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(2)]
    bulk = harness.run_shear_test("Unrolled_ADMM_Gaussian(8)", work / "eval", work / "sweep_bulk", snrs=(100,),
                                  n_gal=5, batch_size=4, device="cpu", state_dict=torch.load(work / "flagship.pt"))
    return dict(work=work, ranks=ranks, jsteps=steps, jhist=jhist, jsweep=jsweep, bulk=bulk)


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


def test_train_step_over_two_ranks_matches_jax_mesh(two_ranks):
    # fit's first three steps (its first epoch), two ranks of 2 against JAX's
    # step on the global 4 sharded over make_mesh(2), from the same bridged
    # state.  Loss at 1e-5 of JAX's; the BatchNorm running statistics at
    # 1e-5, the means after the first step (from the second on they carry
    # the SubNet's zero-gradient conv biases, which Adam moves by a whole lr
    # either way: 0.1 momentum x 2 lr = 4e-5), the variances, which no bias
    # moves, after every step; the parameters after 3 steps as
    # tests/test_torch_train.py holds them (0.02 lr; the SubNet's zero-gradient
    # conv biases only finite); Adam's count.  With per-rank BatchNorm
    # statistics the first loss reads 8.5e-3 from JAX's (CHANGES.md, PR 10).
    r0, jsteps = two_ranks["ranks"][0], two_ranks["jsteps"]
    assert len(r0["losses"]) == len(jsteps) == 6
    for k, (got_loss, got, (want_loss, want)) in enumerate(zip(r0["losses"][:3], r0["states"], jsteps)):
        assert abs(got_loss - want_loss) <= 1e-5 * abs(want_loss), (k, got_loss, want_loss)
        for name, w in want["model"].items():
            if "running_var" in name or "running_mean" in name and k == 0:
                np.testing.assert_allclose(got["model"][name].numpy(), w.numpy(), rtol=1e-5, atol=1e-5,
                                           err_msg=(k, name))
    got, want = r0["states"][2], jsteps[2][1]
    for name, w in want["model"].items():
        if "running_" in name or "num_batches" in name:
            continue
        if zero_grad_param(name):
            assert torch.isfinite(got["model"][name]).all(), name
        else:
            assert params_close(got["model"][name], w, 0), name
    assert got["step"] == 3 and got["opt_state"]["count"] == want["opt_state"]["count"] == 3


def test_fit_over_two_ranks_matches_jax_mesh(two_ranks):
    # fit for 2 epochs of 3 steps and 1 validation batch: the histories'
    # losses at 5e-4 of JAX's, as tests/test_torch_device_resident.py holds
    # its loop (Adam moves the SubNet's zero-gradient conv biases by a whole lr
    # either way, and eval-mode BatchNorm, on running means, does not cancel
    # them), the same best step and checkpoints; each saved checkpoint's
    # parameters (the zero-gradient biases only finite) as params_close holds
    # them, its running variances at 1e-5, its running means within the biases' drift
    # (0.1 momentum x 2 lr after each of the k - 1 earlier updates: 0.1 k (k -
    # 1) lr after k steps) plus 1e-5, its step; rank 0 alone wrote the files
    work, jhist = two_ranks["work"], two_ranks["jhist"]
    hist = json.loads((work / "fit_port" / "run_history.json").read_text())
    assert hist == two_ranks["ranks"][0]["history"]
    other = two_ranks["ranks"][1]["history"]  # the same but for its own epoch times
    assert {k: v for k, v in other.items() if k != "epoch_time"} == {k: v for k, v in hist.items() if k != "epoch_time"}
    assert set(hist) == set(jhist) and hist["best_step"] == jhist["best_step"]
    assert hist["best_epoch"] == jhist["best_epoch"]
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(hist[key], jhist[key], rtol=5e-4, err_msg=key)
    saved = sorted(p.name for p in (work / "fit_port").iterdir() if p.is_dir())
    assert saved == sorted(p.name for p in (work / "fit_jax").iterdir() if p.is_dir()) and saved
    for name in saved:
        epoch = int(name.removeprefix("run_").removesuffix("epochs"))
        got = restore_checkpoint(work / "fit_port", "run", epoch)
        jst = jckpt.restore_checkpoint(work / "fit_jax", "run", epoch)
        want = model_state_dict(as_np(jst["params"]), as_np(jst["batch_stats"]))
        assert got["step"] == int(jst["step"]) == 3 * epoch
        for k, w in want.items():
            if "num_batches" in k:
                continue
            if "running_var" in k:
                np.testing.assert_allclose(got["model"][k].numpy(), w.numpy(), rtol=1e-5, atol=1e-5, err_msg=k)
            elif "running_mean" in k:
                steps = 3 * epoch
                drift = 0.1 * steps * (steps - 1) * LR
                np.testing.assert_allclose(got["model"][k].numpy(), w.numpy(), rtol=1e-5, atol=drift + 1e-5,
                                           err_msg=k)
            elif zero_grad_param(k):
                assert torch.isfinite(got["model"][k]).all(), k
            else:
                assert params_close(got["model"][k], w, 0 if epoch == 1 else 3 * epoch), (name, k)


@pytest.mark.parametrize("loss", LOSSES)
def test_every_loss_over_two_ranks_is_the_global_batch_loss(two_ranks, loss):
    # Each rank's loss on its shard inside parallel.global_batch, averaged over
    # the ranks, against the loss of the whole batch in one process: the
    # value at 1e-6 (BestEllipse at 5e-5, its float32 value's distance from
    # its float64 value, 1.58e-5, chip_smoke.py: its fits are batched matrix
    # products and SVDs that round per batch size), the gradient w.r.t. the
    # reconstruction (the ranks' / world size, stacked) at 1e-6 of its largest
    # entry (BestEllipse at chip_smoke.py's LOSS_GRAD_TOL, 1e-4).  Four losses are means of per-sample terms; the Shape loss squares
    # a batch mean and all-reduces it itself.
    ranks, pair = two_ranks["ranks"], dict(np.load(two_ranks["work"] / "loss_pair.npz"))
    rec = torch.from_numpy(pair["rec"]).requires_grad_()
    want = build_loss(loss)(torch.from_numpy(pair["gt"]), rec)
    want.backward()
    got, want_value = sum(r["loss_values"][loss] for r in ranks) / 2, float(want.detach())
    assert abs(got - want_value) <= (5e-5 if loss == "BestEllipse" else 1e-6) * abs(want_value), (got, want_value)
    grad = torch.cat([r["loss_grads"][loss] for r in ranks]) / 2
    tol = 1e-4 if loss == "BestEllipse" else 1e-6
    assert float((grad - rec.grad).abs().max()) <= tol * float(rec.grad.abs().max())


@pytest.mark.parametrize("method", SWEEP)
def test_shear_sweep_over_two_ranks_matches_jax_mesh(two_ranks, method):
    # 10 galaxies at a global batch of 4 (a ragged last batch of 2, padded and
    # trimmed): the rec_shear rows at 1e-5 (1 + |g|) of JAX's mesh sweep, the
    # results file written once, with the same keys
    got, want = two_ranks["ranks"][0][method], two_ranks["jsweep"][method]
    assert got == two_ranks["ranks"][1][method]
    on_disk = json.loads((two_ranks["work"] / "sweep_port" / method / "results.json").read_text())
    assert {k: v for k, v in on_disk.items() if k not in ("time", "time_spread")} == got
    assert got.keys() == want.keys() and got["100"].keys() == want["100"].keys()
    for key in ("rec_shear", "gt_shear") if method == "No_Deconv" else ("rec_shear",):
        g, w = np.asarray(got["100"][key]), np.asarray(want["100"][key])
        assert g.shape == w.shape == (10, 3) and np.isfinite(g).all()
        assert (np.abs(g - w) / (1 + np.abs(w))).max() <= SHEAR_TOL, key


def test_flagship_sweep_over_two_ranks_matches_the_bulk_path(two_ranks):
    # the trained flagship (trained/, bridged) swept by the two ranks, 5
    # galaxies at a global batch of 4, against the single-device bulk path in
    # this process at 1e-5 (1 + |g|), as tests/test_torch_eval.py holds it to JAX
    got, want = two_ranks["ranks"][0]["flagship"]["100"], two_ranks["bulk"]["100"]
    g, w = np.asarray(got["rec_shear"]), np.asarray(want["rec_shear"])
    assert g.shape == w.shape == (5, 3) and np.isfinite(g).all()
    assert (np.abs(g - w) / (1 + np.abs(w))).max() <= SHEAR_TOL


def test_time_sweep_over_two_ranks(two_ranks):
    # whole batches only (8 of the 10 galaxies), timed between barriers, written by rank 0
    seconds, n = two_ranks["ranks"][0]["time"]
    assert n == 8 and seconds > 0


# --- the command line under torchrun -------------------------------------------------


def test_cli_train_over_two_ranks_matches_one_process(tmp_path):
    # `torchrun --nproc_per_node 2 ... train --n_devices 2` against the same
    # command in this process, 20 stamps (2 steps of 8 and a validation batch
    # of 2, which divides over the ranks): the train loss at 1e-5, the
    # validation loss at 5e-4 (see the fit test), the checkpoint's parameters
    # as params_close holds them (the SubNet's zero-gradient conv biases
    # finite), its running variances at 1e-5, its step and Adam count
    data = chip_smoke().write_dataset(tmp_path / "data", n=20, seed=3)
    args = ["train", "--data_path", data, "--n_epochs", "1", "--batch_size", 8, "--n_iters", 1, "--seed", 0,
            "--device", "cpu"]
    torchrun(*args, "--n_devices", 2, "--model_save_path", tmp_path / "two")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cli.main([*map(str, args), "--model_save_path", str(tmp_path / "one")])
    finally:
        torch.set_num_threads(threads)
    name = "Gaussian_PnP_ADMM_1iters_MultiScale"
    h2, h1 = (json.loads((tmp_path / d / f"{name}_history.json").read_text()) for d in ("two", "one"))
    np.testing.assert_allclose(h2["train_loss"], h1["train_loss"], rtol=1e-5)
    np.testing.assert_allclose(h2["val_loss"], h1["val_loss"], rtol=5e-4)
    got, want = (restore_checkpoint(tmp_path / d, name, 1) for d in ("two", "one"))
    steps = len(train_val_indices(20, 0.9, 0)[0]) // 8
    assert got["step"] == want["step"] == steps and got["opt_state"]["count"] == steps
    for k, w in want["model"].items():
        if zero_grad_param(k) or "num_batches" in k or "running_mean" in k:
            assert torch.isfinite(got["model"][k].float()).all(), k
        elif "running_var" in k:
            np.testing.assert_allclose(got["model"][k].numpy(), w.numpy(), rtol=1e-5, atol=1e-5, err_msg=k)
        else:
            assert params_close(got["model"][k], w, steps), k


def test_cli_test_over_two_ranks_matches_one_process(tmp_path):
    # `torchrun --nproc_per_node 2 ... test --n_devices 2` (the mesh path)
    # against the same command in this process (the bulk path): the rows at
    # 1e-5 (1 + |g|), the ground truth's shear too
    root = write_test_split(tmp_path / "data", n=10, seed=5)
    args = ["test", "--data_path", root, "--n_gal", 10, "--eval_batch_size", 4, "--snrs", 100, "--device", "cpu",
            "--methods", "No_Deconv", "Richard-Lucy(10)"]
    torchrun(*args, "--n_devices", 2, "--result_path", tmp_path / "two")
    cli.main([*map(str, args), "--result_path", str(tmp_path / "one")])
    for method in ("No_Deconv", "Richard-Lucy(10)"):
        got, want = (json.loads((tmp_path / d / method / "results.json").read_text())["100"] for d in ("two", "one"))
        assert got.keys() == want.keys()
        for key in ("rec_shear", "gt_shear") if method == "No_Deconv" else ("rec_shear",):
            g, w = np.asarray(got[key]), np.asarray(want[key])
            assert g.shape == w.shape == (10, 3)
            assert (np.abs(g - w) / (1 + np.abs(w))).max() <= SHEAR_TOL, (method, key)


def test_cli_refuses_a_world_size_it_was_not_given(tmp_path):
    # --n_devices 2 in a process alone raises; so does train --online on more than one device
    with pytest.raises(ValueError, match="n_devices=2, but the process group has 1 rank"):
        cli.main(["train", "--data_path", str(tmp_path), "--n_devices", "2", "--device", "cpu"])
    with pytest.raises(SystemExit, match="one device"):
        cli.main(["train", "--online", "--n_devices", "2", "--device", "cpu"])
