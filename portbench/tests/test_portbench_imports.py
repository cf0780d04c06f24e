"""What a run loads: nothing whose top-level module name is jax, jaxlib,
flax, optax, orbax or gigagan_tpu (gigagan_tpu_torch is another name);
and the reference loads nothing of the port."""

import json
import subprocess
import sys

from portbench import harness

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
{imports}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def loaded(imports: str) -> set:
    code = PROBE.format(root=str(harness.ROOT), imports=imports)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    names = loaded(
        "from portbench import run, harness, program, faults, readings\n"
        "from portbench.tests import tiny\n"
        "c = harness.resolve('t2i-train-b8')\n"
        "harness.driver(c); harness.driver(harness.resolve('qs-sample-b1'))\n"
        "[harness.reader(m['name']) for m in c.per_layer]\n"
        "import gigagan_tpu_torch, gigagan_tpu_torch.train.trainer\n"
        "from gigagan_tpu_torch.ops.kernels import build\n")
    assert "gigagan_tpu_torch" in names
    assert not names & set(harness.FORBIDDEN), names & set(harness.FORBIDDEN)


def test_the_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "gigagan_tpu_torch_probe", sys)
    assert "gigagan_tpu_torch_probe" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "gigagan_tpu.models", sys)
    assert "gigagan_tpu.models" in harness.forbidden_modules()


def test_the_reference_loads_nothing_of_the_port():
    names = loaded(
        "import pkgutil, importlib, portbench.reference as r\n"
        "for m in pkgutil.iter_modules(r.__path__):\n"
        "    importlib.import_module('portbench.reference.' + m.name)\n")
    assert "gigagan_tpu_torch" not in names
    assert not names & set(harness.FORBIDDEN)
