"""The port's host half of the paper's method against the JAX package:
the scalar oracle, the scalar RS-dataflow model, the polynomial basis,
the fits, their cross validation and datasets, and the transformer
workload bridge.

The same seeded inputs go through ``repro`` and ``repro_torch``; every
comparison is bit-equal (``np.array_equal`` / float ``==``): the fit is
host numpy in both, op for op.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import dataflow as ref_dataflow
from repro.core import oracle as ref_oracle
from repro.core import ppa as ref_ppa
from repro.core import workloads as ref_workloads
from repro.core.pe import PE_TYPES

from repro_torch import convert
from repro_torch.core import dataflow, oracle, ppa, workloads
from repro_torch.core.dataflow import AcceleratorConfig as PortConfig

SCALAR_TARGETS = ("clock_mhz", "pe_area_um2", "array_area_mm2",
                  "gbuf_area_mm2", "area_mm2", "leakage_mw",
                  "array_power_mw", "gbuf_power_mw", "power_mw")


def port_cfg(cfg):
  return PortConfig(*dataclasses.astuple(cfg))


def port_layers(layers):
  return convert.layers_from_tuples(dataclasses.astuple(l) for l in layers)


def assert_models_equal(got, want):
  for f in ("degree", "y_scale", "log_target"):
    assert getattr(got, f) == getattr(want, f), f
  for f in ("exponents", "col_scale", "coef"):
    a, b = getattr(got, f), getattr(want, f)
    assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.fixture(scope="module")
def resnet20():
  return ref_workloads.get_network("resnet20")


@pytest.fixture(scope="module")
def five_layers(resnet20):
  return resnet20[:5]


# ---------------------------------------------------------------------------
# the scalar oracle and the scalar dataflow model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pe_type", sorted(PE_TYPES))
def test_scalar_oracle_bit_equal(pe_type, resnet20):
  cfgs = ref_ppa.sample_configs(pe_type, 12, seed=7)
  layers = port_layers(resnet20)
  for cfg in cfgs:
    pc = port_cfg(cfg)
    for name in SCALAR_TARGETS:
      assert getattr(oracle, name)(pc) == getattr(ref_oracle, name)(cfg), name
    for salt, pct in (("clk", 0.004), ("area", 0.005), ("pwr", 0.005)):
      assert oracle._variation(pc, salt, pct) == \
          ref_oracle._variation(cfg, salt, pct)
    assert oracle._variation_key_ints(pc) == \
        ref_oracle._variation_key_ints(cfg)
    assert dataclasses.astuple(oracle.characterize(pc, layers)) == \
        dataclasses.astuple(ref_oracle.characterize(cfg, resnet20))
    for pl, rl in zip(layers[:4], resnet20[:4]):
      assert oracle.characterize_layer_latency(pc, pl) == \
          ref_oracle.characterize_layer_latency(cfg, rl)


def test_scalar_helpers_bit_equal():
  rng = np.random.RandomState(3)
  for z in rng.randint(0, 2**62, 50, dtype=np.int64).tolist() + [0, 2**64 - 1]:
    assert oracle._mix64(z) == ref_oracle._mix64(z)
  for bits, words in [(0, 64), (-1, 8), (1, 1), (96, 6), (7168, 448),
                      (4194304, 262144)]:
    assert oracle._sram_area_um2(bits, words) == \
        ref_oracle._sram_area_um2(bits, words)
  assert oracle.ORACLE_VERSION == ref_oracle.ORACLE_VERSION
  cfg = ref_dataflow.AcceleratorConfig()
  assert port_cfg(cfg).hw_features() == cfg.hw_features()
  assert port_cfg(cfg).latency_hw_features() == cfg.latency_hw_features()


@pytest.mark.parametrize("pe_type", ["INT16", "LightPE-1", "FP32"])
def test_scalar_dataflow_bit_equal(pe_type, resnet20):
  layers = port_layers(resnet20)
  assert [l.features() for l in layers] == [l.features() for l in resnet20]
  for cfg in ref_ppa.sample_configs(pe_type, 6, seed=11):
    pc = port_cfg(cfg)
    clk = ref_oracle.clock_mhz(cfg)
    leak = ref_oracle.leakage_mw(cfg)
    for pl, rl in zip(layers, resnet20):
      got = dataflow.simulate_layer(pc, pl, clk)
      want = ref_dataflow.simulate_layer(cfg, rl, clk)
      assert dataclasses.astuple(got) == dataclasses.astuple(want)
      assert dataflow.layer_energy_pj(pc, pl, got, clk, leak) == \
          ref_dataflow.layer_energy_pj(cfg, rl, want, clk, leak)
    lat, en, stats = dataflow.simulate_network(pc, layers, clk, leak)
    r_lat, r_en, r_stats = ref_dataflow.simulate_network(cfg, resnet20, clk,
                                                         leak)
    assert (lat, en) == (r_lat, r_en)
    assert [dataclasses.astuple(s) for s in stats] == \
        [dataclasses.astuple(s) for s in r_stats]


# ---------------------------------------------------------------------------
# the polynomial basis and features
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args, rows", [((4, 5), 126), ((14, 4, 2), 603),
                                        ((12, 3, None), 455), ((3, 0), 1)])
def test_monomial_exponents_equal(args, rows):
  got = ppa.monomial_exponents(*args)
  want = ref_ppa.monomial_exponents(*args)
  assert got.shape == (rows, args[0])
  assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("n_features, degree, max_vars",
                         [(4, 5, None), (14, 4, 2)])
def test_poly_features_equal_on_host_and_in_torch(n_features, degree,
                                                  max_vars):
  rng = np.random.RandomState(n_features)
  x = rng.uniform(0.5, 600.0, (257, n_features))
  exps = ref_ppa.monomial_exponents(n_features, degree, max_vars)
  scale = np.maximum(np.max(np.abs(x), axis=0), 1e-12)
  want = ref_ppa.poly_features(x, exps, scale)
  assert np.array_equal(ppa.poly_features(x, exps, scale), want)
  got = ppa.poly_features_t(torch.from_numpy(x), exps,
                            torch.from_numpy(scale))
  assert got.shape == (exps.shape[0], x.shape[0])
  assert np.array_equal(got.numpy().T, want)


def test_poly_sum_is_the_fixed_order_sum():
  rng = np.random.RandomState(5)
  phi = rng.normal(size=(40, 33)) * 10.0 ** rng.randint(-8, 8, (40, 1))
  coef = rng.normal(size=40)
  want = np.zeros(33)
  for j in range(40):
    want = want + phi[j] * coef[j]
  got = ppa.poly_sum(torch.from_numpy(phi), torch.from_numpy(coef))
  assert np.array_equal(got.numpy(), want)


def test_metrics_equal():
  rng = np.random.RandomState(8)
  y = rng.uniform(0.1, 10.0, 200)
  p = y * rng.uniform(0.9, 1.1, 200)
  for name in ("mape", "rmspe", "r2"):
    assert getattr(ppa, name)(y, p) == getattr(ref_ppa, name)(y, p), name


# ---------------------------------------------------------------------------
# fits, cross validation and datasets
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def int16_dataset():
  cfgs = ref_ppa.sample_configs("INT16", 60, seed=2)
  return cfgs, ref_ppa.power_area_dataset(cfgs)


def test_sample_configs_and_datasets_equal(int16_dataset, five_layers):
  cfgs, (x, p, a) = int16_dataset
  got = ppa.sample_configs("INT16", 60, seed=2)
  assert got == [port_cfg(c) for c in cfgs]
  gx, gp, ga = ppa.power_area_dataset(got)
  for g, w in ((gx, x), (gp, p), (ga, a)):
    assert np.array_equal(g, w)
  lx, ly = ppa.latency_dataset(got[:9], port_layers(five_layers))
  wx, wy = ref_ppa.latency_dataset(cfgs[:9], five_layers)
  assert np.array_equal(lx, wx) and np.array_equal(ly, wy)
  assert ppa.latency_feature_row(got[0], port_layers(five_layers)[2]) == \
      ref_ppa.latency_feature_row(cfgs[0], five_layers[2])


@pytest.mark.parametrize("target, degree, max_vars, log_target", [
    ("power", 5, None, False), ("area", 3, None, False),
    ("latency", 4, 2, True), ("latency", 2, None, False)])
def test_fit_poly_equal(int16_dataset, five_layers, target, degree, max_vars,
                        log_target):
  cfgs, (x, p, a) = int16_dataset
  if target == "latency":
    x, y = ref_ppa.latency_dataset(cfgs[:30], five_layers)
  else:
    y = p if target == "power" else a
  got = ppa.fit_poly(x, y, degree, max_vars, log_target=log_target)
  want = ref_ppa.fit_poly(x, y, degree, max_vars, log_target=log_target)
  assert_models_equal(got, want)
  assert np.array_equal(got.predict(x[:17]), want.predict(x[:17]))


@pytest.mark.parametrize("log_target", [False, True])
def test_kfold_cv_and_select_degree_equal(int16_dataset, log_target):
  _, (x, p, _) = int16_dataset
  assert ppa.kfold_cv(x, p, 3, k=4, seed=1, log_target=log_target) == \
      ref_ppa.kfold_cv(x, p, 3, k=4, seed=1, log_target=log_target)
  got = ppa.select_degree(x, p, degrees=range(1, 5), log_target=log_target)
  want = ref_ppa.select_degree(x, p, degrees=range(1, 5),
                               log_target=log_target)
  assert got == want


@pytest.mark.parametrize("n_train, n_layers", [(60, 5), (240, None)])
def test_fit_ppa_models_equal(n_train, n_layers):
  """INT16 on five resnet20 layers, and at the paper's settings
  (degree 5, n_train 240) over resnet20 + vgg16."""
  layers = ref_workloads.get_network("resnet20")
  if n_layers is None:
    layers = layers + ref_workloads.get_network("vgg16")
  else:
    layers = layers[:n_layers]
  got = ppa.fit_ppa_models("INT16", degree=5, n_train=n_train,
                           layers=port_layers(layers))
  want = ref_ppa.fit_ppa_models("INT16", degree=5, n_train=n_train,
                                layers=layers)
  assert (got.pe_type, got.degree) == (want.pe_type, want.degree)
  for target in ("power", "area", "latency"):
    assert_models_equal(getattr(got, target), getattr(want, target))
  assert got.latency.coef.shape == (603,) and got.power.coef.shape == (126,)


def test_fit_ppa_models_default_layers_equal():
  got = ppa.fit_ppa_models("LightPE-2", degree=2, n_train=20, seed=4)
  want = ref_ppa.fit_ppa_models("LightPE-2", degree=2, n_train=20, seed=4)
  for target in ("power", "area", "latency"):
    assert_models_equal(getattr(got, target), getattr(want, target))


# ---------------------------------------------------------------------------
# the transformer workload bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tokens", [1, 17, 512, 4096])
def test_matmul_layer_equal(tokens):
  assert dataclasses.astuple(workloads.matmul_layer("m", tokens, 1024, 3072)) \
      == dataclasses.astuple(ref_workloads.matmul_layer("m", tokens, 1024,
                                                        3072))


@pytest.mark.parametrize("gated, experts", [(True, 1), (False, 1), (True, 8)])
def test_lm_block_workload_equal(gated, experts):
  args = ("blk", 512, 1024, 16, 8, 128, 3072)
  got = workloads.lm_block_workload(*args, gated=gated,
                                    n_experts_active=experts)
  want = ref_workloads.lm_block_workload(*args, gated=gated,
                                         n_experts_active=experts)
  assert [dataclasses.astuple(l) for l in got] == \
      [dataclasses.astuple(l) for l in want]
