"""What the benchmark loads, checked in fresh processes: no module whose
top-level name is jax, jaxlib, flax, reverb_tpu, chip_smoke or bench
(names compared whole: reverb_tpu_torch is not reverb_tpu), and nothing
of the program in the reference."""

from __future__ import annotations

import json
import subprocess
import sys

from benchmark import core

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
{body}
tops = sorted({{m.split('.', 1)[0] for m in sys.modules}})
print(json.dumps(tops))
"""


def loaded(body: str):
    out = subprocess.run([sys.executable, '-c',
                          PROBE.format(root=str(core.ROOT), body=body)],
                         capture_output=True, text=True, timeout=300,
                         check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_dry_run_loads_nothing_forbidden(tiny):
    tops = loaded(f"""
from benchmark import run
rc = run.main(['--workload', 'whisper_tiny_train', '--seed', '3',
               '--seconds', '1', '--dry-run',
               '--bench', {str(tiny / 'BENCHMARK.json')!r}])
assert rc == 0
""")
    assert 'reverb_tpu_torch' in tops
    assert not tops & set(core.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    tops = loaded("""
import benchmark.reference.whisper
""")
    assert 'torch' in tops
    assert not tops & ({'reverb_tpu_torch'} | set(core.FORBIDDEN))


def test_whole_names_are_compared(monkeypatch):
    monkeypatch.setitem(sys.modules, 'reverb_tpu_torchx', object())
    assert 'reverb_tpu' not in core.forbidden_loaded()
    monkeypatch.setitem(sys.modules, 'bench.sub', object())
    assert 'bench' in core.forbidden_loaded()
