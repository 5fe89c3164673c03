"""Tiers of some of the JAX package's own tests, set by name.

The JAX package and its test files are kept as they were written, so the
tiers below are given here rather than as decorators in those files. The
hook runs before `tests/conftest.py` skips the `reference` tier and before
`-m` selects by marker. Paths are node ids, relative to the repo's root.
"""
import pytest

# The JAX package's TPU dispatch machinery: the phase executor with its
# `merge_locals` modes and AOT precompile, and the 8-device virtual mesh.
# The port does not port it (`montage_gan_tpu_torch/training/loop_aio.py`)
# and no port test uses it as an oracle. Each of these compiles for minutes
# on a CPU; `pytest tests/ -m slow` runs them.
SLOW = {
    "tests/test_phase_exec.py": (
        "test_phase_executor_trains",
        "test_global_phase_accumulation",
        "test_phase_executor_with_accumulation",
        "test_executor_on_mesh_matches_single_device",
        "test_merge_all_matches_per_layer",
        "test_precompile_covers_production_programs",
    ),
    "tests/test_bucket_exec.py": (
        "test_bucket_matches_per_layer_within_staleness_tolerance",
        "test_bucket_accumulation_rounds",
    ),
    "tests/test_mid_tier.py": (
        "test_mid_accum_linearity_through_phase_program",
        "test_mid_merge_all_matches_per_layer",
    ),
    "tests/test_graft_entry.py": ("test_dryrun_multichip_8",),
    "tests/test_parallel.py": (
        "test_parallel_matches_single_device",
        "test_parallel_runs_multiple_steps",
    ),
}

# Tests that build pickles from the upstream reference repo's classes
# (`custom`, `torch_utils`), so they need the repo as the rest of the
# `reference` tier does.
REFERENCE = {
    "tests/test_pkl_import.py": (
        "test_extract_state_dict_matches_torch",
        "test_generate_cli_from_pkl",
        "test_generate_cli_conditional_class_label",
        "test_convert_pickle_cli_roundtrip",
        "test_calc_metrics_cli_from_pkl",
        "test_generator_variables_from_pkl_forward_parity",
    ),
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card and skips without one; run on the "
                   "card by the command in tests/test_torch_up_conv.py")


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(config, items):
    for item in items:
        path = item.nodeid.split("::")[0]
        if item.originalname in SLOW.get(path, ()):
            item.add_marker(pytest.mark.slow)
        if item.originalname in REFERENCE.get(path, ()):
            item.add_marker(pytest.mark.reference)
