"""The port's examples of the model stack (crash_campaign on lm-train,
serve_recovery, train_lm), each run on the CPU in a fresh interpreter that
never loads jax.  Each plan it prints equals the JAX package's at the same
app, configuration and seed: crash_campaign's persisted objects the JAX
example's, serve_recovery's and train_lm's plans JAX's run_workflow."""
import os
import re

from repro.core import WorkflowConfig as JaxWorkflowConfig
from repro.core import run_workflow as jax_run_workflow
from repro.hpc.suite import ci_app as jax_ci_app
from repro.hpc.suite import default_cache as jax_default_cache
from test_torch_examples_workflow import run_jax_example, run_port_example


def _line(stdout, prefix):
    lines = [l for l in stdout.splitlines() if l.startswith(prefix)]
    assert len(lines) == 1, stdout[-3000:]
    return lines[0]


def _jax_plan(name, n_tests):
    app = jax_ci_app(name)
    wf = jax_run_workflow(app, JaxWorkflowConfig(n_tests=n_tests, cache=jax_default_cache(app),
                                                 seed=0))
    return wf.critical, dict(sorted(wf.plan.region_freq.items()))


def test_crash_campaign_persists_the_jax_examples_objects(tmp_path):
    args = ["--tests", "8", "--iters", "10"]
    port = run_port_example("crash_campaign", args, tmp_path / "port")
    ref = run_jax_example("crash_campaign", args, tmp_path / "jax")
    head = "app=lm-train candidates=('params', 'mu', 'nu', 'k')"
    assert _line(port, "app=") == _line(ref, "app=") and port.startswith(head)
    persist = re.compile(r"^persist (\(.*\)) at loop end", re.M)
    assert persist.findall(port) == persist.findall(ref) == ["('params',)"]


def test_serve_recovery_plans_as_jax_and_resumes(tmp_path):
    port = run_port_example("serve_recovery", ["--tests", "4"], tmp_path)
    critical, freq = _jax_plan("decode", 4)
    assert _line(port, "critical decode state:") == f"critical decode state: {critical}"
    assert _line(port, "plan:").startswith(f"plan: flush at regions {freq};")
    assert "[failure] injected failure at decode step 24; restarting..." in port
    assert "[restore] resuming decode at step 24 from arena" in port
    assert "'resumed': True" in port and "'output_shape': [4, 81]" in port
    for policy in ("none", "checkpoint", "easycrash", "hybrid"):
        assert re.search(rf"^  {policy:10s} goodput=", port, re.M), port[-2000:]
    assert os.path.isdir(tmp_path / "repro_torch_example_serve" / "serve_arena")


def test_train_lm_plans_as_jax_and_restores_from_the_arena(tmp_path):
    """At 62 steps the injected failure at step 60 fires, and the trainer
    restores from the EasyCrash arena and ends at step 62, as the JAX
    example does."""
    port = run_port_example("train_lm", ["--steps", "62", "--tests", "4"], tmp_path)
    critical, freq = _jax_plan("lm-train", 4)
    assert _line(port, "plan:").startswith(f"plan: flush {critical} at regions {freq};")
    assert "[restore] source=fresh step=0" in port
    assert "[restore] source=easycrash step=60" in port
    assert "'final_step': 62" in port
    assert os.path.isdir(tmp_path / "repro_torch_example_train")
