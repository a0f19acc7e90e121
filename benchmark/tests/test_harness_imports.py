"""No module the harness or the reference loads has the top-level name
jax, jaxlib, flax or fastslam_tpu (compared whole: fastslam_tpu_torch is
the program), and the reference loads nothing of the program."""

import subprocess
import sys

from benchmark import harness

PROBE = """
import sys
{imports}
tops = sorted({{m.split('.')[0] for m in sys.modules}})
print(','.join(tops))
"""


def loaded(imports: str) -> set:
    out = subprocess.run([sys.executable, "-c", PROBE.format(imports=imports)],
                         cwd=harness.ROOT, capture_output=True, text=True, check=True)
    return set(out.stdout.strip().split(","))


def test_harness_loads_no_jax():
    tops = loaded("import benchmark.run, benchmark.control, benchmark.drivers.online\n"
                  "from benchmark.drivers import filter as f\n"
                  "f.program_step(); f.program_config(__import__('benchmark.harness').harness"
                  ".load_cell('filter-motion-100k'))")
    assert "fastslam_tpu_torch" in tops
    assert not tops & set(harness.FORBIDDEN_MODULES)


def test_reference_loads_nothing_of_the_program():
    tops = loaded("import benchmark.reference.filter, benchmark.reference.online, "
                  "benchmark.drive, benchmark.roofline, benchmark.trace")
    assert "torch" in tops
    assert not tops & ({"fastslam_tpu_torch"} | set(harness.FORBIDDEN_MODULES))


def test_forbidden_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "fastslam_tpu_torch_fake", sys)
    assert "fastslam_tpu" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "fastslam_tpu.core", sys)
    assert harness.forbidden_loaded() == ["fastslam_tpu"]
