"""The lifetime of every process ``chip_smoke.py`` starts, held on the CPU
with small Python children: ``spawn`` (the run's token, a process group of
its own, death with the thread that started it), ``stop_all`` (SIGTERM to
every group at once, one shared deadline, SIGKILL to every group left),
``reap`` (every process carrying the run's token found through ``/proc``,
killed and reported) and ``guarded`` (SIGTERM raises ``SystemExit``, so
every ``finally`` runs and the reap with it).

Each test has a time limit of a few seconds, enforced by its own waits,
and ends by asserting that no process carrying its token is left."""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import textwrap
import time
import uuid

import pytest

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a child that ignores SIGTERM, says it is up, and sleeps
IGNORER = ("import signal, sys, time; "
           "signal.signal(signal.SIGTERM, signal.SIG_IGN); "
           "print('up', flush=True); time.sleep(60)")


@pytest.fixture
def token(monkeypatch):
    tok = uuid.uuid4().hex
    monkeypatch.setenv(chip_smoke.RUN_TOKEN, tok)
    yield tok
    left = chip_smoke.reap(tok)
    assert left == [], f"the test left processes behind: {left}"


def _alive(pid: int) -> bool:
    """Whether ``pid`` runs (a zombie, whose environ reads empty, does
    not)."""
    try:
        with open(f"/proc/{pid}/environ", "rb") as f:
            return bool(f.read())
    except OSError:
        return False


def _gone_within(pid: int, seconds: float) -> bool:
    end = time.monotonic() + seconds
    while time.monotonic() < end:
        if not _alive(pid):
            return True
        time.sleep(0.02)
    return not _alive(pid)


def _python(code: str, **kw):
    return chip_smoke.spawn([sys.executable, "-c", textwrap.dedent(code)],
                            stdout=subprocess.PIPE, text=True, cwd=ROOT,
                            **kw)


def _pids(proc, n: int, seconds: float = 10.0) -> list:
    """The first ``n`` lines of ``proc``'s output, as pids."""
    out = []
    end = time.monotonic() + seconds
    while len(out) < n and time.monotonic() < end:
        line = proc.stdout.readline()
        if not line:
            break
        out.append(int(line.split()[-1]))
    assert len(out) == n, f"the child said {out}"
    return out


GRANDCHILD = """
    import signal, subprocess, sys, time
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    g = subprocess.Popen([sys.executable, "-c", {code!r}])
    print("grandchild", g.pid, flush=True)
    time.sleep(60)
"""


def test_stop_all_takes_a_grandchild_that_ignores_sigterm(token):
    """The child and its grandchild both ignore SIGTERM; the grandchild is
    a plain Popen, in the child's group. After one short deadline the
    group is killed, the grandchild with it."""
    child = _python(GRANDCHILD.format(
        code="import signal, time; "
             "signal.signal(signal.SIGTERM, signal.SIG_IGN); time.sleep(60)"))
    (grand,) = _pids(child, 1)
    assert os.getpgid(grand) == child.pid  # spawn made the group
    t0 = time.monotonic()
    assert chip_smoke.stop_all([child], grace_s=0.5) == [None]  # killed
    assert time.monotonic() - t0 < 3.0
    assert _gone_within(grand, 3.0)
    assert chip_smoke.token_processes(token) == []


def test_reap_finds_a_grandchild_that_left_the_group(token):
    """A grandchild that calls setsid() leaves the child's group, so
    teardown by group misses it; ``reap`` finds it by the token, kills it
    and reports it as a straggler."""
    child = _python(GRANDCHILD.format(
        code="import os, time; os.setsid(); time.sleep(60)"))
    (grand,) = _pids(child, 1)
    end = time.monotonic() + 3.0
    while os.getpgid(grand) != grand and time.monotonic() < end:
        time.sleep(0.02)
    assert os.getpgid(grand) == grand
    chip_smoke.stop_all([child], grace_s=0.0)
    assert _alive(grand)  # escaped the group's SIGKILL
    found = chip_smoke.reap(token)
    assert [pid for pid, _ in found] == [grand]
    assert "os.setsid()" in found[0][1]
    assert _gone_within(grand, 3.0)


def test_a_node_wrapper_dies_with_its_parent(token):
    """A wrapper process (started by ``spawn``) starts a node process of
    its own through ``spawn``, then is SIGKILLed, so no ``finally`` of it
    runs. The node, which ignores SIGTERM and is in a group of its own,
    dies with it all the same: ``PR_SET_PDEATHSIG``."""
    wrapper = _python(f"""
        import subprocess, sys, time
        import chip_smoke
        p = chip_smoke.spawn([sys.executable, "-c", {IGNORER!r}],
                             stdout=subprocess.DEVNULL)
        print("node", p.pid, flush=True)
        time.sleep(60)
    """)
    (node_pid,) = _pids(wrapper, 1)
    assert _alive(node_pid)
    assert os.getpgid(node_pid) == node_pid != os.getpgid(wrapper.pid)
    wrapper.kill()
    wrapper.wait(timeout=5)
    assert _gone_within(node_pid, 3.0)


def test_sixteen_sigterm_ignorers_stop_within_one_deadline(token):
    """Sixteen processes that ignore SIGTERM cost one deadline, not
    sixteen: every group is signalled at once, then SIGKILLed together; a
    process that exits on SIGTERM is reported with its seconds."""
    procs = [_python(IGNORER) for _ in range(16)]
    polite = _python("import time; print('up', flush=True); time.sleep(60)")
    for p in procs + [polite]:
        assert p.stdout.readline().strip() == "up"
    t0 = time.monotonic()
    exits = chip_smoke.stop_all(procs + [polite], grace_s=1.0)
    took = time.monotonic() - t0
    assert exits[:16] == [None] * 16  # killed at the one deadline
    assert exits[16] is not None and exits[16] < 0.9  # exited on SIGTERM
    assert took < 1.0 + 3.0, took
    assert all(p.returncode == -signal.SIGKILL for p in procs)
    assert polite.returncode == -signal.SIGTERM


def test_a_guarded_run_ended_by_sigterm_runs_its_finally():
    """SIGTERM to a run under ``guarded``: the body's ``finally`` runs,
    ``reap`` kills the child the body left behind and names it on a line
    of its own, and the run exits with 128 + SIGTERM."""
    code = textwrap.dedent("""
        import sys, time
        import chip_smoke

        def body():
            child = chip_smoke.spawn([sys.executable, "-c", %r])
            print("child", child.pid, flush=True)
            try:
                time.sleep(60)
            finally:
                print("finally ran", flush=True)

        sys.exit(chip_smoke.guarded(body))
    """) % IGNORER
    env = {k: v for k, v in os.environ.items() if k != chip_smoke.RUN_TOKEN}
    run = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env,
                           stdout=subprocess.PIPE, text=True)
    try:
        line = run.stdout.readline()
        child = int(line.split()[-1])
        time.sleep(0.3)  # the child is up; the body sleeps
        run.send_signal(signal.SIGTERM)
        out, _ = run.communicate(timeout=15)
    finally:
        if run.poll() is None:
            run.kill()
            run.wait()
    assert run.returncode == 128 + signal.SIGTERM, out
    assert "finally ran" in out
    assert f"[reap] straggler pid {child}, killed" in out
    assert _gone_within(child, 3.0)


def test_spawn_refuses_an_env_without_the_token(token):
    """An ``env=`` that is not a copy of ``os.environ`` would drop the
    token, and ``reap`` could not find the process: ``spawn`` refuses it."""
    with pytest.raises(ValueError):
        chip_smoke.spawn([sys.executable, "-c", "pass"], env={"PATH": "/bin"})


def test_spawn_execs_the_command_in_a_group_of_its_own(token):
    """``spawn``'s child sets its death signal in a fresh interpreter and
    then execs the command: within a moment the process is the command
    itself (its pid, its command line), leading a group of its own, and a
    command that does not exist raises here, as ``Popen`` would."""
    proc = chip_smoke.spawn(["sleep", "30"])
    try:
        end = time.monotonic() + 5.0
        while time.monotonic() < end:
            with open(f"/proc/{proc.pid}/cmdline", "rb") as f:
                if f.read() == b"sleep\x0030\x00":
                    break
            time.sleep(0.02)
        else:
            raise AssertionError("the child never became the command")
        assert os.getpgid(proc.pid) == proc.pid != os.getpgid(0)
    finally:
        assert chip_smoke.stop_all([proc], grace_s=2.0)[0] is not None
    with pytest.raises(FileNotFoundError):
        chip_smoke.spawn(["no-such-command-anywhere"])
