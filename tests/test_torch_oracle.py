"""The PyTorch port's exact oracle against the JAX package's numpy path.

Same seeded design points go through ``repro.core.oracle`` (numpy) and
``repro_torch.core.oracle`` (torch on the CPU); every output must match
bit for bit (atol 0).  Utilization is held to the reference's vector
path, which differs from its scalar ``characterize`` by an ulp.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import oracle as ref_oracle
from repro.core.pe import PE_TYPES
from repro.core.workloads import get_network
from repro.explore import DesignSpace, VectorOracleBackend

from repro_torch import convert
from repro_torch.core import oracle
from repro_torch.core.dataflow import AcceleratorConfig as PortConfig
from repro_torch.core.exact import div, floor_div
from repro_torch.explore import TorchOracleBackend

FIELDS = ("clock_mhz", "area_mm2", "power_mw", "latency_s", "energy_mj",
          "utilization")
METRICS = ("latency_s", "power_mw", "area_mm2")


def port_table(table):
  from repro.core.table import COLUMNS
  cols = {name: getattr(table, name) for name in COLUMNS}
  cols["pe_code"] = table.pe_code
  return convert.table_from_columns(cols, table.pe_type_names)


def port_layers(layers):
  return convert.layers_from_tuples(dataclasses.astuple(l) for l in layers)


@pytest.fixture(scope="module")
def six_type_table():
  # ~2k rows over all six PE types
  return DesignSpace(pe_types=tuple(PE_TYPES)).sample_table(340, seed=21)


@pytest.mark.parametrize("network", ["resnet20", "vgg16"])
def test_characterize_batch_bit_identical(six_type_table, network):
  layers = get_network(network)
  want = ref_oracle.characterize_batch(six_type_table, layers)
  inputs = {k: torch.from_numpy(v) for k, v in
            oracle.batch_inputs(port_table(six_type_table)).items()}
  got = oracle.characterize_batch(inputs, port_layers(layers))
  assert set(six_type_table.pe_type_names) == set(PE_TYPES)
  for f in FIELDS:
    np.testing.assert_array_equal(getattr(got, f).numpy(), getattr(want, f),
                                  err_msg=f)


def test_batch_inputs_extend_the_reference_bundle(six_type_table):
  want = ref_oracle.batch_inputs(six_type_table)
  got = oracle.batch_inputs(port_table(six_type_table))
  for k, v in want.items():
    np.testing.assert_array_equal(got[k], v, err_msg=k)
  # the host-precomputed transcendental columns (F2, F6)
  np.testing.assert_array_equal(got["sqrt_n_pe"], np.sqrt(want["n_pe"]))
  np.testing.assert_array_equal(
      got["dec_gbuf_area"],
      np.maximum(np.ceil(np.log2(np.maximum(want["gbuf_kb"] * 512, 2.0))),
                 1.0))


@pytest.mark.parametrize("chunk_size", [97, 65536])
def test_backend_evaluate_table_parity(six_type_table, chunk_size):
  layers = get_network("resnet20")[:7]
  base = VectorOracleBackend().evaluate_table(six_type_table, layers)
  got = TorchOracleBackend(chunk_size=chunk_size, device="cpu").evaluate_table(
      port_table(six_type_table), port_layers(layers))
  rel = max(float(np.max(np.abs(getattr(got, c) / getattr(base, c) - 1.0)))
            for c in METRICS)
  assert rel == 0.0
  np.testing.assert_array_equal(got.pe_type, base.pe_type)


def test_backend_evaluate_config_list():
  from repro.core.dataflow import AcceleratorConfig
  cfgs = [AcceleratorConfig(), AcceleratorConfig("LightPE-1", 8, 32, 6, 448,
                                                  64, 512, 25.6)]
  layers = get_network("resnet20")[:3]
  base = VectorOracleBackend().evaluate(cfgs, layers)
  port_cfgs = [PortConfig(*dataclasses.astuple(c)) for c in cfgs]
  got = TorchOracleBackend(device="cpu").evaluate(port_cfgs,
                                                  port_layers(layers))
  for c in METRICS:
    np.testing.assert_array_equal(getattr(got, c), getattr(base, c))
  assert got.cfgs == tuple(port_cfgs)


def test_div_matches_numpy_where_rtruediv_does_not():
  x = np.random.RandomState(0).uniform(0.5, 1e6, 20000)
  t = torch.from_numpy(x)
  naive = (1000.0 / t).numpy()
  assert (naive != 1000.0 / x).any()  # reciprocal-times-scalar (F1)
  np.testing.assert_array_equal(div(1000.0, t).numpy(), 1000.0 / x)
  np.testing.assert_array_equal(div(t, 3.0).numpy(), x / 3.0)
  np.testing.assert_array_equal(div(t, torch.flip(t, [0])).numpy(),
                                x / x[::-1])


def test_floor_div_matches_numpy():
  x = np.floor(np.random.RandomState(1).uniform(0.0, 1e4, 20000))
  t = torch.from_numpy(x)
  for d in (1.0, 3.0, 7.0, 24.0):
    np.testing.assert_array_equal(floor_div(t, d).numpy(),
                                  np.floor_divide(x, d))
  np.testing.assert_array_equal(floor_div(1e4, t + 1.0).numpy(),
                                np.floor_divide(1e4, x + 1.0))


def test_div_keeps_the_operand_device_and_dtype():
  t = torch.arange(1.0, 5.0, dtype=torch.float64)
  out = div(2.0, t)
  assert out.dtype == torch.float64 and out.device == t.device
