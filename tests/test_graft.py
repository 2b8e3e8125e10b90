"""The driver entry points must stay green (entry + multichip dryrun)."""
import os
import subprocess
import sys


def test_graft_entry_subprocess():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, os.path.join(repo, "__graft_entry__.py")],
                       capture_output=True, text=True, timeout=600, cwd=repo,
                       env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "entry ok" in r.stdout
    assert "dryrun_multichip ok" in r.stdout
