"""The port's copy of the reference's recorded tables
(`deploy/reference_results.py`): a mirror of
`tests/test_deploy.py::test_reference_results_tables`, and every table equal
to the JAX package's."""
import os

import pytest

from on_device_image_captioning_torch.deploy import reference_results as rr
from on_device_image_captioning_tpu.deploy import reference_results as jrr

TABLES = ("PARAMS", "GFLOPS", "LATENCY_S", "KARPATHY_TEST_SINGLE", "KARPATHY_TEST_ENSEMBLE",
          "VIZWIZ_VAL_BASELINE")


def test_reference_results_tables(tmp_path):
    assert rr.PARAMS["baseline"] == 233_803_076
    out = str(tmp_path / "cmp.png")
    rr.plot_comparison(109.8, out)
    assert os.path.getsize(out) > 1000
    table = rr.scores_table({"CIDEr": 1.40, "Bleu_1": 0.82})
    assert "CIDEr" in table and "reference" in table


@pytest.mark.parametrize("name", TABLES)
def test_tables_equal_the_jax_package(name):
    assert getattr(rr, name) == getattr(jrr, name)


def test_scores_table_equals_the_jax_package():
    measured = {"CIDEr": 1.40, "Bleu_1": 0.82, "SPICE": 0.2}
    assert rr.scores_table(measured) == jrr.scores_table(measured)
    assert rr.scores_table(measured, rr.VIZWIZ_VAL_BASELINE) == jrr.scores_table(
        measured, jrr.VIZWIZ_VAL_BASELINE)
