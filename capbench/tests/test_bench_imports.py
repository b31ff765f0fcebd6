"""Nothing the benchmark loads is JAX or the JAX package, and the reference
loads nothing of the program under test. Module names are compared by their
top-level part, whole: the program's name begins with the JAX package's."""
import subprocess
import sys

from capbench.manifest import ROOT

JAX_SIDE = {"jax", "jaxlib", "flax", "on_device_image_captioning_tpu"}
PROGRAM = "on_device_image_captioning_torch"


def loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sorted({m.split('.')[0] "
         "for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(out.stdout.split())


def test_harness_and_entries_load_no_jax():
    code = ("import capbench.run, capbench.readings, capbench.program\n"
            "from capbench.manifest import Manifest\nm = Manifest()\n"
            "[m.entry_class(m.traffic(w['traffic'])['entry']) for w in m.data['workloads']]\n"
            "[m.reader(x['name']) for x in m.data['per_layer']]\n"
            "from capbench.program import model_config\n"
            "model_config(m.config('expv2_swinL384_serve_bf16'))\n"
            "import on_device_image_captioning_torch.api\n"
            "import on_device_image_captioning_torch.cli.generate_features\n"
            "import on_device_image_captioning_torch.train.train_step")
    top = loaded_after(code)
    assert PROGRAM in top
    assert not top & JAX_SIDE


def test_reference_loads_nothing_of_the_program():
    top = loaded_after("import capbench.reference.model, capbench.reference.checks, "
                       "capbench.reference.radam, capbench.weights, capbench.costs")
    assert PROGRAM not in top
    assert not top & JAX_SIDE
