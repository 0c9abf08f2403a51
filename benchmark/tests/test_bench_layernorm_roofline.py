"""The reader of the LayerNorm pair's share of its bytes bound
(``metrics/train.layernorm_roofline.py``) on hand-made trace reductions."""
import pytest

import harness

METRIC = "train.layernorm_roofline"
FWD = ("void (anonymous namespace)::tic_layernorm_fwd_kernel<__nv_bfloat16, "
       "__nv_bfloat16, 8, 32>(__nv_bfloat16 const*, float const*, float "
       "const*, __nv_bfloat16*, float*, float*, long long, int, float)")
BWD = ("void (anonymous namespace)::tic_layernorm_bwd_kernel<__nv_bfloat16, "
       "__nv_bfloat16, 8, 32>(__nv_bfloat16 const*, __nv_bfloat16 const*, "
       "float const*, float const*, float const*, __nv_bfloat16*, float*, "
       "long long, int)")
SUM = ("(anonymous namespace)::tic_layernorm_dparams_kernel(float const*, "
       "int, int, float*, float*)")
VIT_L = {"hidden": 1024, "layers": 24, "heads": 16, "mlp": 4096,
         "image": 224, "patch": 16, "classes": 120, "n": 197, "eps": 1e-12}


def _readings(kernels: dict, batch=256, shape=VIT_L):
    """A b256 run's readings whose trace holds ``kernels`` (name: (count,
    seconds)) beside an aten kernel."""
    table = {name: {"count": c, "seconds": s} for name, (c, s) in
             kernels.items()}
    table["void at::native::vectorized_elementwise_kernel"] = {
        "count": 9, "seconds": 0.5}
    return {"batch": batch, "shape": shape, "trace": {"kernels": table}}


def test_ten_bytes_an_element_over_one_pairs_mean_time():
    # 8 traced b256 steps of 49 LayerNorms: forward 0.08 ms, backward
    # 0.12 ms and the sum 0.004 ms a launch
    got = harness.metric_reader(METRIC).read(_readings(
        {FWD: (392, 392 * 0.08e-3), BWD: (392, 392 * 0.12e-3),
         SUM: (392, 392 * 0.004e-3)}))
    elements = 256 * 197 * 1024
    assert got == pytest.approx(100 * 10 * elements / 3.35e12 / 0.204e-3)


def test_each_kernels_own_mean_a_launch_the_trace_missed_included():
    # the trace lost one forward record: each kernel is read by its own mean
    got = harness.metric_reader(METRIC).read(_readings(
        {FWD: (391, 391 * 0.08e-3), BWD: (392, 392 * 0.12e-3),
         SUM: (392, 392 * 0.004e-3)}, batch=8))
    assert got == pytest.approx(100 * 10 * 8 * 197 * 1024 / 3.35e12
                                / 0.204e-3)


@pytest.mark.parametrize("readings", [
    {},                                                   # no trace
    _readings({}),                        # the parent: aten's kernels only
    _readings({FWD: (49, 49e-4), BWD: (49, 49e-4)}),      # no sum kernel
    _readings({FWD: (49, 49e-4), BWD: (49, 0.0), SUM: (49, 49e-6)}),
    _readings({FWD: (49, 49e-4), BWD: (49, 49e-4), SUM: (49, 49e-6)},
              shape={"hidden": 1024}),                    # no token count
    _readings({FWD: (49, 49e-4), BWD: (49, 49e-4), SUM: (49, 49e-6)},
              batch=None),                                # no batch
])
def test_reads_nothing_without_the_three_kernels_and_a_shape(readings):
    assert harness.metric_reader(METRIC).read(readings) is None


def test_listed_for_the_b256_cell_and_moving_train_img_per_s():
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    entry = next(m for m in spec["per_layer"] if m["name"] == METRIC)
    assert entry["workloads"] == ["vitl-nvit-b256"]
    assert (entry["moves"], entry["source"], entry["layer"]) == (
        "train_img_per_s", "device_trace", "models.vit")
