"""Data-parallel training of heat_tpu_torch against heat_tpu: the rest of
``ht.nn``, ``DataParallel``, the optimizers with DASO, the schedulers and
the data path (``Dataset``, ``DataLoader``, the shuffles, ``MNISTDataset``).

Both packages get the same numpy input and the same Threefry key. At world
size 1 (heat_tpu on the 8-device CPU mesh of conftest.py) and in the 4-rank
gloo world of test_torch_distributed.py (the cases of ``_train_cases`` in
torch_mp_worker.py, against heat_tpu on 4 devices):

- initial parameters and dropout masks are equal bit for bit; scheduler
  learning rates and plateau states exactly; permutations exactly;
- forwards, losses and the parameters after every training step agree
  within rtol 1e-5, atol 1e-6 (float32 sums in other orders: XLA's
  backward of the global mean against torch's of each rank's sum, one
  all-reduce, then the division);
- the optimizers' updates (optax's, written out) equal optax's bit for bit
  on the same gradients;
- a convolution's gradients equal ``jax.grad``'s within the same bound.

Shapes are small: an MLP 16-8-4, a CNN 1->4->8 on 10 x 10, batches of 32
and 30, three steps (DASO four).
"""

import gzip
import os
import struct

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import heat_tpu as jht
import heat_tpu.nn as jnn
import heat_tpu.optim as jopt
import heat_tpu_torch as ht
from heat_tpu_torch.core._threefry import fold_in, seed_key
from heat_tpu_torch.core.interop import nn_params_from_numpy

import torch_mp_worker as worker
from test_torch_distributed import WORLD, _jcomm, _result, _shard, jcomm, ranks  # noqa: F401 (fixtures)

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    ht.use_device("cpu")
    jht.array([0.0])  # heat_tpu turns x64 on for the CPU with its first array


def _order(tree) -> list:
    """A heat_tpu parameter tree as numpy in the port's parameter order."""
    if isinstance(tree, (tuple, list)):
        return [a for t in tree for a in _order(t)]
    return [np.asarray(tree[k]) for k in ("weight", "bias") if k in tree]


def _close(got, want) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=RTOL, atol=ATOL)


def _build(kind, nn):
    return worker.train_cnn(nn) if kind == "cnn" else worker.train_mlp(nn)


def _params(model) -> list:
    return [p.detach().numpy().copy() for p in model.module.parameters()]


# --------------------------------------------------------------------- #
# modules                                                               #
# --------------------------------------------------------------------- #
CONVS = {"same2": dict(kernel_size=2, padding="same"),  # the CNN's layers take 0 and "same" at 3 x 3
         "valid_stride2": dict(padding="valid", stride=2)}


@pytest.mark.parametrize("label", list(CONVS))
def test_conv2d_init_forward_and_gradients_match_heat_tpu(label):
    kw = {"kernel_size": 3, **CONVS[label]}
    jc, tc = jnn.Conv2d(2, 3, **kw), ht.nn.Conv2d(2, 3, **kw, key=seed_key(4))
    p = jc.init(jax.random.PRNGKey(4))
    for a, b in zip(_order(p), tc.parameters()):
        np.testing.assert_array_equal(b.detach().numpy(), a)
    x = np.random.default_rng(1).standard_normal((2, 2, 7, 6)).astype(np.float32)
    r = np.random.default_rng(2).standard_normal(jax.eval_shape(jc.apply, p, x).shape).astype(np.float32)

    def forward_and_gradients(q, z):  # one compiled program: the forward and the gradient of sum(out * r)
        out, pull = jax.vjp(jc.apply, q, z)
        return (out, *pull(jnp.asarray(r)))

    ref, gp, gx = jax.jit(forward_and_gradients)(p, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = tc(xt)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    (out * torch.from_numpy(r)).sum().backward()
    _close([tc.weight.grad, tc.bias.grad, xt.grad], [gp["weight"], gp["bias"], gx])


def test_conv2d_same_padding_matches_torch_and_refuses_a_stride():
    c = ht.nn.Conv2d(1, 2, 4, padding="same", key=seed_key(1))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 1, 6, 6)).astype(np.float32))
    ref = torch.nn.functional.conv2d(x, c.weight, c.bias, padding="same")
    np.testing.assert_allclose(c(x).detach().numpy(), ref.detach().numpy(), rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError):
        ht.nn.Conv2d(1, 2, 3, stride=2, padding="same")


def test_conv2d_leaves_the_process_wide_tf32_switch_as_it_was():
    before = torch.backends.cudnn.allow_tf32
    c = ht.nn.Conv2d(1, 2, 3, key=seed_key(0))
    c(torch.ones(1, 1, 5, 5, requires_grad=True)).sum().backward()
    assert torch.backends.cudnn.allow_tf32 == before


@pytest.mark.parametrize("pool,dtype", [("MaxPool2d", "float32"), ("MaxPool2d", "int32"), ("AvgPool2d", "float32")])
def test_pools_match_heat_tpu(pool, dtype):
    x = (np.random.default_rng(3).standard_normal((2, 3, 7, 9)) * 100).astype(dtype)
    for args in ((2,), (3, 2)):
        ref = np.asarray(getattr(jnn, pool)(*args).apply({}, jnp.asarray(x)))
        got = getattr(ht.nn, pool)(*args)(torch.from_numpy(x)).numpy()
        assert got.dtype == ref.dtype
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["ReLU", "GELU", "Tanh", "Sigmoid", "LogSoftmax", "Softmax", "Flatten"])
def test_activations_and_flatten_match_heat_tpu(name):
    x = np.random.default_rng(5).standard_normal((4, 3, 5)).astype(np.float32)
    ref = np.asarray(getattr(jnn, name)().apply({}, jnp.asarray(x)))
    got = getattr(ht.nn, name)()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("p", [0.25, 0.9])
@pytest.mark.parametrize("kind", ["Dropout", "Dropout2d"])
def test_dropout_masks_equal_heat_tpus_bit_for_bit(kind, p):
    x = np.random.default_rng(6).standard_normal((37, 5, 3, 2)).astype(np.float32) + 10.0
    ref = np.asarray(getattr(jnn, kind)(p).apply({}, jnp.asarray(x), train=True, key=jax.random.PRNGKey(9)))
    d = getattr(ht.nn, kind)(p)
    got = d(torch.from_numpy(x), key=seed_key(9)).numpy()
    np.testing.assert_array_equal(got == 0, ref == 0)
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    # a rank's rows of the global batch draw the same rows of the mask
    part = d(torch.from_numpy(x[10:20]), key=seed_key(9), batch=(10, 37)).numpy()
    np.testing.assert_array_equal(part, got[10:20])
    assert (d.eval()(torch.from_numpy(x)).numpy() == x).all()


def test_dropout_edges_match_heat_tpu():
    x = torch.ones(4, 3)
    assert (ht.nn.Dropout(1.0)(x) == 0).all() and (ht.nn.Dropout(0.0)(x) == x).all()
    with pytest.raises(ValueError):
        ht.nn.Dropout(0.5)(x)  # training mode needs a key, as heat_tpu's apply(train=True)
    with pytest.raises(ValueError):
        ht.nn.Dropout(1.5)
    ref = np.asarray(jnn.functional.dropout(jnp.ones((4, 3)), 0.5, key=jax.random.PRNGKey(2)))
    np.testing.assert_array_equal(ht.nn.functional.dropout(x, 0.5, key=seed_key(2)).numpy(), ref)


def test_carried_weights_need_one_dict_a_module():
    model = _build("mlp", ht.nn)
    tree = tuple({name: p.detach().numpy() for name, p in m.named_parameters()} for m in model.children())
    nn_params_from_numpy(model, tree)
    with pytest.raises(KeyError):
        nn_params_from_numpy(model, tree[:-1])
    with pytest.raises(KeyError):
        nn_params_from_numpy(model, tree[:-1] + ({"weight": tree[-1]["weight"]},))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", ["MSELoss", "NLLLoss", "CrossEntropyLoss"])
def test_losses_match_heat_tpu(name, weighted):
    rng = np.random.default_rng(7)
    out = rng.standard_normal((12, 4)).astype(np.float32)
    tgt = rng.standard_normal((12, 4)).astype(np.float32) if name == "MSELoss" else rng.integers(0, 4, 12)
    w = (np.arange(12) < 9).astype(np.float32) if weighted else None
    ref = float(getattr(jnn, name)().raw(jnp.asarray(out), jnp.asarray(tgt), None if w is None else jnp.asarray(w)))
    got = float(getattr(ht.nn, name)().raw(torch.from_numpy(out), torch.from_numpy(tgt),
                                           None if w is None else torch.from_numpy(w)))
    assert abs(got - ref) <= RTOL * abs(ref) + ATOL
    if not weighted:  # on DNDarrays: the mean over the global batch
        call = getattr(ht.nn, name)()(ht.array(out, split=0), ht.array(tgt, split=0))
        assert call.shape == () and call.split is None
        assert abs(float(call) - ref) <= RTOL * abs(ref) + ATOL


# --------------------------------------------------------------------- #
# the optimizers                                                        #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["sgd", "adam", "adamw", "sgd_plain"])
def test_local_optimizers_give_optax_updates_bit_for_bit(name):
    make = (lambda o: o.SGD(0.1)) if name == "sgd_plain" else (lambda o: worker.train_optimizer(o, name))
    jo, to = make(jopt), make(ht.optim)
    rng = np.random.default_rng(8)
    p0 = rng.standard_normal((5, 7)).astype(np.float32)
    jp, st = {"w": jnp.asarray(p0)}, None
    st = jo.tx.init(jp)
    tp = torch.from_numpy(p0.copy())
    hyper, ts = to.hyperparams(), to.init([tp])
    for _ in range(4):
        g = (rng.standard_normal((5, 7)) * 10.0 ** rng.uniform(-6, 1)).astype(np.float32)
        u, st = jo.tx.update({"w": jnp.asarray(g)}, st, jp)
        jp = optax.apply_updates(jp, u)
        to.update([tp], [torch.from_numpy(g)], ts, hyper)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp["w"]))
    assert hyper["learning_rate"] == float(st.hyperparams["learning_rate"])


_REFERENCE = {}


def _dp_reference(label):
    """heat_tpu's training of ``TRAIN_DP[label]`` on 4 devices from key 11:
    its initial parameters, (loss, parameters) after each step, and the
    trained model's forward. A data-parallel step's result does not depend
    on the mesh, so the world-size-1 cases and the 4-rank world share it."""
    if label not in _REFERENCE:
        kind, opt, n = worker.TRAIN_DP[label]
        x, y = worker.train_data(kind, n)
        comm = _jcomm()
        jm = jnn.DataParallel(_build(kind, jnn), comm=comm, key=11)
        init = jax.tree.map(np.asarray, jm.params)
        jo = jopt.DataParallelOptimizer(worker.train_optimizer(jopt, opt), jm)
        X, Y = jht.array(x, split=0, comm=comm), jht.array(y, split=0, comm=comm)
        steps = [(float(jo.step(X, Y)), _order(jm.params)) for _ in range(worker.TRAIN_STEPS)]
        _REFERENCE[label] = (init, steps, jm(X).numpy())
    return _REFERENCE[label]


@pytest.mark.parametrize("label", list(worker.TRAIN_DP))
def test_data_parallel_training_matches_heat_tpu(ranks, jcomm, label):
    """At world size 1 from key 11 (the initial parameters bit for bit)
    and from heat_tpu's weights carried across, and in the 4-rank world,
    against one heat_tpu run."""
    kind, opt, n = worker.TRAIN_DP[label]
    x, y = worker.train_data(kind, n)
    init, steps, out = _dp_reference(label)
    for carried in (False, True):
        tm = ht.nn.DataParallel(_build(kind, ht.nn), key=3 if carried else 11)
        if carried:
            nn_params_from_numpy(tm.module, init)
        else:  # Sequential's split of the key, one key a module, bit for bit
            for a, b in zip(_order(init), tm.module.parameters()):
                np.testing.assert_array_equal(b.detach().numpy(), a)
        to = ht.optim.DataParallelOptimizer(worker.train_optimizer(ht.optim, opt), tm)
        for loss, params in steps:
            lt = to.step(ht.array(x, split=0), ht.array(y, split=0))
            assert lt.shape == () and lt.split is None
            assert abs(float(lt) - loss) <= RTOL * abs(loss) + ATOL
            _close(_params(tm), params)
        np.testing.assert_allclose(tm(ht.array(x, split=0)).numpy(), out, rtol=RTOL, atol=ATOL)
    for r, res in enumerate(_result(ranks, f"train_{label}")):
        assert res["lshape"][0] == jcomm.chunk((n,), 0, rank=r)[1][0]
        for got, (loss, params) in zip(res["steps"], steps):
            assert abs(got["loss"] - loss) <= RTOL * abs(loss) + ATOL
            _close(got["params"], params)
            assert got["counts"] == {"all-reduce": 1}  # the gradients, the count and the loss in one
        assert all(np.array_equal(res["every"][q], res["every"][0]) for q in range(WORLD))  # bit for bit
        assert res["out_split"] == 0
        np.testing.assert_allclose(res["out"], out, rtol=RTOL, atol=ATOL)


def test_checkpoint_round_trip_restores_training_bit_for_bit():
    x, y = worker.train_data("cnn", 16)
    X, Y = ht.array(x, split=0), ht.array(y, split=0)
    model = ht.nn.DataParallel(worker.train_cnn(ht.nn), key=2)
    opt = ht.optim.DataParallelOptimizer(ht.optim.Adam(0.01), model)
    opt.step(X, Y)
    state = {k: (v.clone() if torch.is_tensor(v) else v) for k, v in opt.checkpoint_state().items()}
    opt.set_lr(0.005)
    first = [float(opt.step(X, Y)) for _ in range(2)], _params(model)
    opt.step(X, Y)
    opt.load_checkpoint_state(state)
    assert opt.lr == np.float32(0.01)
    opt.set_lr(0.005)
    again = [float(opt.step(X, Y)) for _ in range(2)], _params(model)
    assert first[0] == again[0]
    for a, b in zip(first[1], again[1]):
        np.testing.assert_array_equal(a, b)
    other = ht.optim.DataParallelOptimizer(ht.optim.Adam(0.01), ht.nn.DataParallel(worker.train_mlp(ht.nn)))
    with pytest.raises(ValueError):
        other.load_checkpoint_state(state)


def test_wire_quant_refuses_naming_its_item():
    """``wire_quant`` takes heat_tpu's modes (an unknown one raises); in a
    world of one rank it is the exact step, as in heat_tpu."""
    x, y = worker.train_data("mlp", 32)
    X, Y = ht.array(x, split=0), ht.array(y, split=0)
    runs = []
    for wire in (None, "int8", "bf16"):
        model = ht.nn.DataParallel(worker.train_mlp(ht.nn), key=3)
        opt = ht.optim.DataParallelOptimizer(ht.optim.SGD(0.05), model, wire_quant=wire)
        assert opt.wire_quant == wire
        runs.append(([float(opt.step(X, Y)) for _ in range(2)], _params(model)))
    for losses, params in runs[1:]:
        assert losses == runs[0][0]
        for a, b in zip(params, runs[0][1]):
            np.testing.assert_array_equal(a, b)
    model = ht.nn.DataParallel(worker.train_mlp(ht.nn))
    with pytest.raises(ValueError):
        ht.optim.DataParallelOptimizer(ht.optim.SGD(), model, wire_quant="int4")
    with pytest.raises(TypeError):
        ht.optim.DataParallelOptimizer(torch.optim.SGD, model)


# --------------------------------------------------------------------- #
# schedulers, the plateau detector and DASO's schedule                  #
# --------------------------------------------------------------------- #
METRICS = [1.0, 0.5, 0.5, 0.5, 0.5, 0.49, 0.49, 0.2, 0.2, 0.2, 0.2, 0.2]


def _sched(lib, name, opt):
    s = lib.optim.lr_scheduler
    return {"step": lambda: s.StepLR(opt, step_size=2, gamma=0.3), "exp": lambda: s.ExponentialLR(opt, gamma=0.7),
            "plateau": lambda: s.ReduceLROnPlateau(opt, factor=0.5, patience=1, min_lr=1e-3)}[name]()


@pytest.mark.parametrize("name", ["step", "exp", "plateau"])
def test_scheduler_rates_equal_heat_tpus_exactly(name):
    jo = jopt.DataParallelOptimizer(jopt.SGD(0.1), jnn.DataParallel(worker.train_mlp(jnn), key=0))
    to = ht.optim.DataParallelOptimizer(ht.optim.SGD(0.1), ht.nn.DataParallel(worker.train_mlp(ht.nn), key=0))
    js, ts = _sched(jht, name, jo), _sched(ht, name, to)
    for m in METRICS:
        args = (m,) if name == "plateau" else ()
        js.step(*args)
        ts.step(*args)
        assert to.lr == jo.lr and ts.get_last_lr() == js.get_last_lr()
        if name == "plateau":
            assert ts.detector.get_state() == js.detector.get_state()


def test_plateau_detector_states_equal_heat_tpus():
    jd, td = jopt.DetectMetricPlateau(patience=2), ht.optim.DetectMetricPlateau(patience=2)
    for m in METRICS:
        assert td.test_if_improving(m) == jd.test_if_improving(m)
        assert td.get_state() == jd.get_state()
    fresh = ht.optim.DetectMetricPlateau()
    fresh.set_state(jd.get_state())
    assert fresh.get_state() == jd.get_state()
    with pytest.raises(ValueError):
        ht.optim.DetectMetricPlateau(mode="sideways")


def test_daso_schedule_takes_heat_tpus_decisions():
    kw = dict(total_epochs=20, warmup_epochs=2, cooldown_epochs=2, stability_level=0.05, max_global_skips=8)
    jd = jopt.DASO(jopt.SGD(0.01), jnn.DataParallel(worker.train_mlp(jnn), key=0), n_nodes=2, **kw)
    td = ht.optim.DASO(ht.optim.SGD(0.01), ht.nn.DataParallel(worker.train_mlp(ht.nn), key=0), n_nodes=1, **kw)
    for loss in [1.0, 0.9] + [0.8] * 10 + [0.2] + [0.8] * 7:
        jd.epoch_loss_logic(loss)
        td.epoch_loss_logic(loss)
        assert (td.global_skip, td.local_skip, td.batches_to_wait) == (jd.global_skip, jd.local_skip, jd.batches_to_wait)
    assert td.epoch == jd.epoch == 20
    sched = ht.optim.lr_scheduler.ExponentialLR(td, gamma=0.5)
    sched.step()
    assert td.lr == np.float32(0.005)


# --------------------------------------------------------------------- #
# names                                                                 #
# --------------------------------------------------------------------- #
def test_every_heat_tpu_name_resolves_to_a_port_object():
    import heat_tpu.utils.data as jdata

    for jmod, tmod, fallback in ((jht.nn, ht.nn, torch.nn), (jht.optim, ht.optim, torch.optim)):
        for name in jmod.__all__:
            obj = getattr(tmod, name)
            assert obj is not getattr(fallback, name, None), name
            assert getattr(obj, "__module__", getattr(obj, "__name__", "")).startswith("heat_tpu_torch"), name
    for name in sorted(n for n in vars(jdata) if not n.startswith("_")):
        obj = getattr(ht.utils.data, name)
        assert getattr(obj, "__module__", getattr(obj, "__name__", "")).startswith("heat_tpu_torch"), name
    assert ht.optim.RMSprop is torch.optim.RMSprop


# --------------------------------------------------------------------- #
# the data path                                                         #
# --------------------------------------------------------------------- #
def _pair(lib, n=37, t_split=0):
    data = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    return lib.utils.data.Dataset(lib.array(data, split=0), targets=lib.array(np.arange(n), split=t_split))


@pytest.mark.parametrize("t_split", [0, None])
def test_shuffle_gives_heat_tpus_permutation(t_split):
    jds, tds = _pair(jht, t_split=t_split), _pair(ht, t_split=t_split)
    jht.random.seed(21)
    ht.random.seed(21)
    jds.Shuffle()
    tds.Ishuffle()
    np.testing.assert_array_equal(tds.htdata.numpy(), jds.htdata.numpy())
    np.testing.assert_array_equal(tds.httargets.numpy(), jds.httargets.numpy())
    assert ht.random.get_state() == jht.random.get_state()
    np.testing.assert_array_equal(tds.htdata.numpy()[:, 0] // 3, tds.httargets.numpy())  # pairs kept


def test_loader_batches_epochs_and_test_sets():
    ds = _pair(ht, 40)
    loader = ht.utils.data.DataLoader(ds, batch_size=16, drop_last=False)
    batches = list(loader)
    assert len(loader) == 3 and [b[0].shape[0] for b in batches] == [16, 16, 8]
    assert len(ht.utils.data.DataLoader(ds, batch_size=16)) == 2
    np.testing.assert_array_equal(np.concatenate([b[1].numpy() for b in batches]), np.arange(40))
    ht.random.seed(1)
    shuffled = ht.utils.data.DataLoader(ds, batch_size=40, shuffle=True)
    first, second = (next(iter(shuffled))[1].numpy() for _ in range(2))
    assert sorted(first) == list(range(40)) and not np.array_equal(first, second)
    frozen = ht.utils.data.DataLoader(_pair(ht, 40), batch_size=40, shuffle=True)
    frozen.dataset.test_set = True
    np.testing.assert_array_equal(next(iter(frozen))[1].numpy(), np.arange(40))
    with pytest.raises(ValueError):
        ht.utils.data.Dataset(ht.array(np.zeros((4, 2)), split=1))


def _idx_files(root, n, gz_labels: bool):
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, size=(n, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, size=(n,), dtype=np.uint8)
    raw = os.path.join(root, "MNIST", "raw")
    os.makedirs(raw, exist_ok=True)
    for prefix in ("train", "t10k"):
        with open(os.path.join(raw, f"{prefix}-images-idx3-ubyte"), "wb") as f:
            f.write(struct.pack(">IIII", 0x803, n, 28, 28) + images.tobytes())
        payload = struct.pack(">II", 0x801, n) + labels.tobytes()
        name = os.path.join(raw, f"{prefix}-labels-idx1-ubyte")
        with (gzip.open(name + ".gz", "wb") if gz_labels else open(name, "wb")) as f:
            f.write(payload)


@pytest.mark.parametrize("gz_labels", [False, True])
def test_mnist_dataset_reads_idx_files_as_heat_tpu_does(tmp_path, gz_labels):
    from heat_tpu.utils.data.mnist import MNISTDataset as JMNIST

    _idx_files(str(tmp_path), 24, gz_labels)
    for train in (True, False):
        got, ref = ht.utils.data.MNISTDataset(str(tmp_path), train=train), JMNIST(str(tmp_path), train=train)
        np.testing.assert_array_equal(got.htdata.numpy(), ref.htdata.numpy())
        np.testing.assert_array_equal(got.httargets.numpy(), ref.httargets.numpy())
        assert got.htdata.dtype.__name__ == ref.htdata.dtype.__name__ and got.test_set == ref.test_set
    shifted = ht.utils.data.MNISTDataset(str(tmp_path), transform=lambda a: (a - 0.5) / 0.5)
    assert float(shifted.htdata.numpy().min()) < 0.0
    with pytest.raises(FileNotFoundError):
        ht.utils.data.MNISTDataset(str(tmp_path / "none"))


# --------------------------------------------------------------------- #
# the 4-rank world                                                      #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("label", list(worker.TRAIN_DASO))
def test_daso_across_ranks_matches_heat_tpu(ranks, jcomm, label):
    x, y = worker.train_data("mlp", 32, seed=93)
    jm = jnn.DataParallel(worker.train_mlp(jnn), comm=jcomm, key=12)
    daso = jopt.DASO(worker.train_optimizer(jopt, "sgd"), jm, n_nodes=2, global_skip=2,
                     compression=worker.TRAIN_DASO[label])
    X, Y = jht.array(x, split=0, comm=jcomm), jht.array(y, split=0, comm=jcomm)
    want = []
    for _ in range(worker.DASO_STEPS):
        want.append((float(daso.step(X, Y)), [_order(jax.tree.map(lambda a: a[node], daso.params)) for node in (0, 1)]))
    evaluated = jm(X).numpy()
    daso.sync_params()
    synced = _order(jax.tree.map(lambda a: a[0], daso.params))
    res = _result(ranks, f"train_{label}")
    for r in range(WORLD):
        for step, (got, (loss, nodes)) in enumerate(zip(res[r]["steps"], want), 1):
            assert abs(got["loss"] - loss) <= RTOL * abs(loss) + ATOL
            _close(got["params"], nodes[r // 2])
            partner = res[r ^ 1]["steps"][step - 1]["params"]  # the other rank of the node
            assert all(np.array_equal(a, b) for a, b in zip(got["params"], partner))
            other = res[(r + 2) % WORLD]["steps"][step - 1]["params"]  # the same place in the other node
            assert all(np.array_equal(a, b) for a, b in zip(got["params"], other)) == (step % 2 == 0)
        np.testing.assert_allclose(res[r]["eval"], evaluated, rtol=RTOL, atol=ATOL)
        _close(res[r]["synced"], synced)


@pytest.mark.parametrize("label", list(worker.SHUFFLES))
def test_shuffle_across_ranks_is_heat_tpus_permutation(ranks, jcomm, label):
    n, t_split = worker.SHUFFLES[label]
    # heat_tpu's randperm is its default mesh's, and the permutation does not depend on the mesh
    ds = _pair(jht, n, t_split)
    jht.random.seed(21)
    ds.Shuffle()
    want, state = ds.htdata.numpy(), jht.random.get_state()
    for r, res in enumerate(_result(ranks, f"shuffle_{label}")):
        np.testing.assert_array_equal(res["data"], _shard(want, 0, r))
        np.testing.assert_array_equal(res["targets"], ds.httargets.numpy())
        assert res["state"] == state
        assert res["counts"] == {"all-to-all": 1 + (t_split == 0)}  # one a split-0 attribute
        assert res["batch_lshape"][0] == 2  # a batch of 8 in even chunks
        np.testing.assert_array_equal(res["batch"], want[:8])
