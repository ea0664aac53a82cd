"""The port's Compute Engine provider (``providers/gce_gpu.py``) against
the JAX package's TPU-VM provider (``ray_tpu/providers/gcp_tpu.py``).

Each provider sits behind a fake transport that answers in its own API's
words: the TPU API's node ``state`` against Compute's instance
``status``. The same scripted life of one node goes through both, on a
fake clock for the handles' 15 s poll throttle, and they must agree step
by step: the ``poll()`` outcomes, the failures before dead, the
deterministic names (prefix aside), ``list_live`` over the same listing,
``terminate_orphan`` with and without a name, swallowed DELETE errors
and the fault-injection points. Then exact checks of the insert (URL and
body, the startup script's module and arguments), the A3 table and the
card-model key (``accelerators/gpu.py``) under a mocked ``nvidia-smi``.
"""

import json
import logging
import shlex
import subprocess
import sys
from pathlib import Path
from unittest import mock

import pytest

import ray_tpu.util.fault_injector as jfi
import ray_tpu_torch.util.fault_injector as tfi
from ray_tpu.core import config as jconfig
from ray_tpu.providers.gcp_tpu import TpuVmNodeProvider
from ray_tpu_torch.accelerators.gpu import GPUAcceleratorManager
from ray_tpu_torch.core import config as tconfig
from ray_tpu_torch.providers.gce_gpu import A3_TYPES, GceGpuNodeProvider

ROOT = Path(__file__).resolve().parents[1]

#: one vocabulary for a node's life, in each API's words
WORDS = {
    "tpu": {"creating": "CREATING", "starting": "STARTING",
            "ready": "READY", "repairing": "REPAIRING", "unknown": "",
            "stopping": "STOPPING", "stopped": "STOPPED",
            "suspending": "SUSPENDING", "suspended": "SUSPENDED",
            "terminated": "TERMINATED"},
    "gce": {"creating": "PROVISIONING", "starting": "STAGING",
            "ready": "RUNNING", "repairing": "REPAIRING", "unknown": "",
            "stopping": "STOPPING", "stopped": "STOPPED",
            "suspending": "SUSPENDING", "suspended": "SUSPENDED",
            "terminated": "TERMINATED"},
}
#: a resource on its way out, which ``list_live`` leaves out
GOING = {"tpu": "DELETING", "gce": "STOPPING"}
ERROR = "error"
SESSION = "s1"
NODE_IDS = ["0123456789abcdef0123456789abcdef",
            "fedcba9876543210fedcba9876543210",
            "00000000000000000000000000000001"]


class FakeApi:
    """A transport for one API: instance GETs answer from a script (a
    word of ``WORDS`` or ``ERROR``), collection GETs from a listing (in
    pages for Compute), DELETEs fail while ``fail_delete`` is set."""

    def __init__(self, api, answers=(), listing=(), list_down=False,
                 fail_delete=False):
        self.api = api
        self.answers = list(answers)
        self.listing = list(listing)
        self.list_down = list_down
        self.fail_delete = fail_delete
        self.requests = []

    def _is_list(self, url):
        path = url.split("?")[0]
        return path.endswith("/nodes" if self.api == "tpu"
                             else "/instances")

    def request(self, method, url, body=None):
        self.requests.append((method, url, body))
        if method == "DELETE":
            if self.fail_delete:
                raise OSError("HTTP Error 503: Service Unavailable")
            return {}
        if method == "POST":
            return {"name": "operations/op-1"}
        if self._is_list(url):
            if self.list_down:
                raise OSError("HTTP Error 500: Internal Server Error")
            return self._page(url)
        answer = self.answers.pop(0)
        if answer == ERROR:
            raise OSError("HTTP Error 500: Internal Server Error")
        return {"state" if self.api == "tpu" else "status":
                WORDS[self.api][answer]}

    def _page(self, url):
        """The listing, each entry (session, node id label, word): one
        response for the TPU API, pages of two for Compute."""
        if self.api == "tpu":
            nodes = []
            for session, nid, word in self.listing:
                labels = {"rtpu-session": session}
                if nid:
                    labels["rtpu-node-id"] = nid
                nodes.append({
                    "name": f"projects/p/locations/z/nodes/rtpu-"
                            f"{(nid or 'x')[:12]}",
                    "state": GOING["tpu"] if word == "going"
                    else WORDS["tpu"][word], "labels": labels})
            return {"nodes": nodes}
        start = int(url.split("pageToken=")[1]) if "pageToken=" in url else 0
        items = []
        for session, nid, word in self.listing[start:start + 2]:
            labels = {"rtpt-session": session}
            if nid:
                labels["rtpt-node-id"] = nid
            items.append({"name": f"rtpt-{(nid or 'x')[:12]}",
                          "status": GOING["gce"] if word == "going"
                          else WORDS["gce"][word], "labels": labels})
        page = {"items": items}
        if start + 2 < len(self.listing):
            page["nextPageToken"] = str(start + 2)
        return page


def make(api, http, session=SESSION):
    if api == "tpu":
        return TpuVmNodeProvider(
            project="p", zone="z", accelerator_type="v5litepod-8",
            runtime_version="tpu-ubuntu2204-base", head_addr="10.0.0.2:6379",
            session=session, http=http)
    return GceGpuNodeProvider(
        project="p", zone="z", machine_type="a3-highgpu-1g",
        image="projects/p/global/images/h100", head_addr="10.0.0.2:6379",
        session=session, http=http)


def bare(name):
    """A resource name's last segment without its prefix."""
    return name.rsplit("/", 1)[-1].split("-", 1)[1]


def word_of(api, status):
    """An API's status back in the shared vocabulary."""
    if status is None or status == "GONE":
        return status
    return {v: k for k, v in WORDS[api].items()}[status]


# ------------------------------------------------------------ the lives

#: (clock, the answer a GET gets, or None where the throttle must hold the
#: GET back) and the outcome ``poll()`` must give at each step
LIVES = {
    "boot": ([(100, "creating"), (105, None), (116, "starting"),
              (132, "ready"), (140, None), (148, "repairing"),
              (164, "unknown"), (180, "ready")],
             [None] * 8),
    "blips": ([(100, ERROR), (116, ERROR), (132, "ready"), (148, ERROR),
               (164, ERROR), (180, ERROR), (181, None), (500, None)],
              [None] * 5 + ["GONE"] * 3),
    **{f"dies {word}": ([(100, "creating"), (116, "ready"), (132, word),
                         (133, None), (400, None)],
                        [None, None, word, word, word])
       for word in ("stopping", "stopped", "suspending", "suspended",
                    "terminated")},
}


def live_program(steps):
    def program(api):
        http = FakeApi(api, answers=[a for _, a in steps if a is not None])
        handle = make(api, http).create_node({}, node_id=NODE_IDS[0])
        out = []
        for t, answer in steps:
            before = len(http.requests)
            with mock.patch("time.monotonic", return_value=float(t)):
                status = handle.poll()
            out.append((word_of(api, status),
                        len(http.requests) - before))
        assert not http.answers, "a scripted answer was never asked for"
        return out
    return program


def fails_before_dead(api):
    """Consecutive GET failures until ``poll()`` reports the node dead."""
    http = FakeApi(api, answers=[ERROR] * 10)
    handle = make(api, http).create_node({}, node_id=NODE_IDS[0])
    for n in range(1, 11):
        with mock.patch("time.monotonic", return_value=100.0 + 16 * n):
            if handle.poll() is not None:
                return n
    return None


def names(api):
    http = FakeApi(api)
    prov = make(api, http)
    out = []
    for nid in NODE_IDS:
        handle = prov.create_node({}, node_id=nid)
        out.append((bare(handle.name), handle.rtpu_node_id,
                    bare(prov.describe(handle)["name"]),
                    bare(prov._name_for(nid))))
    return out


LISTING = [(SESSION, NODE_IDS[0], "ready"), ("other", NODE_IDS[1], "ready"),
           (SESSION, NODE_IDS[1], "creating"), (SESSION, None, "ready"),
           (SESSION, NODE_IDS[2], "terminated"),
           (SESSION, "aaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaa", "going"),
           (SESSION, "bbbbbbbbbbbbbbbbbbbbbbbbbbbbbbbb", "stopped")]


def list_live(api):
    http = FakeApi(api, listing=LISTING)
    got = make(api, http).list_live()
    return {nid: bare(meta["name"]) for nid, meta in got.items()}


def list_live_api_down(api):
    return make(api, FakeApi(api, list_down=True)).list_live()


def orphan_with_name(api):
    http = FakeApi(api)
    prov = make(api, http)
    name = prov.create_node({}, node_id=NODE_IDS[0]).name
    prov.terminate_orphan(NODE_IDS[1], {"name": name})
    (method, url, _), = http.requests[1:]
    return method, url == name


def orphan_without_name(api):
    http = FakeApi(api)
    make(api, http).terminate_orphan(NODE_IDS[1], {})
    (method, url, _), = http.requests
    return method, bare(url)


def swallowed_deletes(api, caplog):
    http = FakeApi(api, fail_delete=True)
    prov = make(api, http)
    handle = prov.create_node({}, node_id=NODE_IDS[0])
    caplog.clear()
    with caplog.at_level(logging.ERROR):
        prov.terminate_node(handle)
        prov.terminate_orphan(NODE_IDS[1], {})
        prov.terminate_orphan(NODE_IDS[2], {"name": handle.name})
    deletes = [r[0] for r in http.requests if r[0] == "DELETE"]
    logged = [r for r in caplog.records if r.exc_info is not None]
    return len(deletes), len(logged)


def fault_points(api):
    """For each point armed to raise: which of the provider's calls
    raise, and whether the transport was reached."""
    fi = jfi if api == "tpu" else tfi
    out = {}
    for point in ("provider.create", "provider.terminate",
                  "autoscaler.pre_create"):
        http = FakeApi(api)
        prov = make(api, http)
        handle = prov.create_node({}, node_id=NODE_IDS[0])
        http.requests.clear()
        fi.configure(f"{point}=raise")
        raised = []
        try:
            for call, fn in (
                    ("create_node",
                     lambda: prov.create_node({}, node_id=NODE_IDS[1])),
                    ("terminate_node", lambda: prov.terminate_node(handle)),
                    ("terminate_orphan",
                     lambda: prov.terminate_orphan(NODE_IDS[2], {}))):
                try:
                    fn()
                except fi.FaultInjected:
                    raised.append(call)
        finally:
            fi.reset()
        out[point] = (raised, len(http.requests))
    return out


AGREEMENT = {
    **{f"poll: {name}": live_program(steps)
       for name, (steps, _) in LIVES.items()},
    "failures before dead": fails_before_dead,
    "deterministic names": names,
    "list_live": list_live,
    "list_live with the API down": list_live_api_down,
    "terminate_orphan with a name": orphan_with_name,
    "terminate_orphan without a name": orphan_without_name,
    "swallowed DELETE errors": swallowed_deletes,
    "fault-injection points": fault_points,
}

#: what both must give, where the comparison alone would let both be wrong
WANT = {
    **{f"poll: {name}": [(o, int(a is not None))
                         for (_, a), o in zip(steps, outcomes)]
       for name, (steps, outcomes) in LIVES.items()},
    "failures before dead": 3,
    "deterministic names": [(nid[:12], nid, nid[:12], nid[:12])
                            for nid in NODE_IDS],
    "list_live": {NODE_IDS[0]: NODE_IDS[0][:12],
                  NODE_IDS[1]: NODE_IDS[1][:12],
                  "bbbbbbbbbbbbbbbbbbbbbbbbbbbbbbbb": "bbbbbbbbbbbb"},
    "list_live with the API down": {},
    "terminate_orphan with a name": ("DELETE", True),
    "terminate_orphan without a name": ("DELETE", NODE_IDS[1][:12]),
    "swallowed DELETE errors": (3, 3),
    "fault-injection points": {
        "provider.create": (["create_node"], 2),
        "provider.terminate": (["terminate_node", "terminate_orphan"], 1),
        "autoscaler.pre_create": ([], 3)},
}


@pytest.mark.parametrize("case", list(AGREEMENT))
def test_gce_provider_agrees_with_tpu_provider(case, caplog):
    program = AGREEMENT[case]
    args = (caplog,) if program is swallowed_deletes else ()
    tpu, gce = program("tpu", *args), program("gce", *args)
    assert gce == tpu
    assert gce == WANT[case]


def test_list_live_follows_the_pages():
    http = FakeApi("gce", listing=LISTING)
    make("gce", http).list_live()
    urls = [url for method, url, _ in http.requests if method == "GET"]
    base = "https://compute.googleapis.com/compute/v1/projects/p/zones/z/" \
           "instances"
    assert urls == [base, f"{base}?pageToken=2", f"{base}?pageToken=4",
                    f"{base}?pageToken=6"]


# ------------------------------------------------------ exact: the insert


def startup_argv(script):
    """The startup script's command, as bash would split it."""
    assert script.startswith("#!/bin/bash\n")
    return shlex.split(script.split("\n", 1)[1].replace("\\\n", ""))


def test_insert_request(tmp_path):
    http = FakeApi("gce")
    prov = make("gce", http)
    nid = NODE_IDS[0]
    handle = prov.create_node({"GPU": 1.0}, node_id=nid)
    (method, url, body), = http.requests
    base = "https://compute.googleapis.com/compute/v1/projects/p/zones/z/" \
           "instances"
    assert (method, url) == ("POST", base)
    (item,) = body["metadata"]["items"]
    assert item["key"] == "startup-script"
    assert {k: v for k, v in body.items() if k != "metadata"} == {
        "name": "rtpt-0123456789ab",
        "machineType": "zones/z/machineTypes/a3-highgpu-1g",
        "disks": [{"boot": True, "autoDelete": True,
                   "initializeParams": {
                       "sourceImage": "projects/p/global/images/h100",
                       "diskSizeGb": 200}}],
        "networkInterfaces": [{"network": "global/networks/default"}],
        "scheduling": {"onHostMaintenance": "TERMINATE"},
        "labels": {"rtpt-session": SESSION, "rtpt-node-id": nid}}
    argv = startup_argv(item["value"])
    assert argv[:5] == ["python3", "-m", "ray_tpu_torch.runtime.node",
                        "10.0.0.2:6379", SESSION]
    assert json.loads(argv[5]) == {
        "resources": None, "object_store_bytes": None, "node_id": nid,
        "config": json.loads(tconfig.GlobalConfig.to_json())}
    assert len(argv) == 6
    # bash reads it
    script = tmp_path / "startup.sh"
    script.write_text(item["value"])
    assert subprocess.run(["bash", "-n", str(script)]).returncode == 0
    assert handle.name == f"{base}/rtpt-0123456789ab"
    assert handle.rtpu_node_id == nid
    assert prov.describe(handle) == {"name": handle.name}

    # the TPU provider's startup script: the same arguments, its module
    jhttp = FakeApi("tpu")
    make("tpu", jhttp).create_node({}, node_id=nid)
    jargv = startup_argv(jhttp.requests[0][2]["metadata"]["startup-script"])
    assert jargv[:3] == ["python3", "-m", "ray_tpu.runtime.node"]
    assert jargv[3:5] == argv[3:5]
    jargs = json.loads(jargv[5])
    assert jargs == {"resources": None, "object_store_bytes": None,
                     "node_id": nid,
                     "config": json.loads(jconfig.GlobalConfig.to_json())}


@pytest.mark.parametrize("machine_type,cards,vcpus", [
    ("a3-highgpu-1g", 1, 26), ("a3-highgpu-2g", 2, 52),
    ("a3-highgpu-4g", 4, 104), ("a3-highgpu-8g", 8, 208)])
def test_a3_node_types(machine_type, cards, vcpus):
    assert A3_TYPES[machine_type] == (cards, vcpus)
    assert GceGpuNodeProvider.node_type(machine_type) == {
        "CPU": float(vcpus), "GPU": float(cards), "GPU-H100": float(cards)}
    assert GceGpuNodeProvider.node_type(machine_type, cpus=8) == {
        "CPU": 8.0, "GPU": float(cards), "GPU-H100": float(cards)}


@pytest.mark.parametrize("machine_type", [
    "a3-highgpu-3g", "a2-highgpu-1g", "n1-standard-8", "v5litepod-8"])
def test_unknown_machine_type_raises(machine_type):
    with pytest.raises(ValueError, match="unknown machine type"):
        GceGpuNodeProvider.node_type(machine_type)
    assert len(A3_TYPES) == 4


# --------------------------------------------------- the card-model key

#: a stand-in for nvidia-smi: ``-L`` lists the cards in $FAKE_SMI_NAMES
#: (one name a line), a query prints them; every call's arguments are
#: appended to $FAKE_SMI_LOG; $FAKE_SMI_RC set makes it fail
NVIDIA_SMI = """#!/bin/sh
echo "$@" >> "$FAKE_SMI_LOG"
[ -n "$FAKE_SMI_RC" ] && exit "$FAKE_SMI_RC"
if [ "$1" = "-L" ]; then
  i=0
  while read -r name; do
    echo "GPU $i: $name (UUID: GPU-$i)"; i=$((i+1))
  done < "$FAKE_SMI_NAMES"
else
  cat "$FAKE_SMI_NAMES"
fi
"""


@pytest.fixture
def smi(tmp_path, monkeypatch):
    """A mocked nvidia-smi first on PATH: -> set(names) and its calls."""
    exe = tmp_path / "nvidia-smi"
    exe.write_text(NVIDIA_SMI)
    exe.chmod(0o755)
    log, names = tmp_path / "calls", tmp_path / "names"
    log.write_text("")
    monkeypatch.setenv("PATH", f"{tmp_path}:/usr/bin:/bin")
    monkeypatch.setenv("FAKE_SMI_LOG", str(log))
    monkeypatch.setenv("FAKE_SMI_NAMES", str(names))
    monkeypatch.delenv("FAKE_SMI_RC", raising=False)

    def set_names(*cards):
        names.write_text("".join(f"{c}\n" for c in cards))
    set_names.calls = lambda: log.read_text().splitlines()
    return set_names


QUERY = "--query-gpu=name --format=csv,noheader"


@pytest.mark.parametrize("cards,visible,want,call", [
    (["NVIDIA H100 80GB HBM3"], "0",
     {"GPU": 1.0, "GPU-H100": 1.0}, f"{QUERY} -i 0"),
    (["NVIDIA H100 80GB HBM3"] * 4, "0,1,2,3",
     {"GPU": 4.0, "GPU-H100": 4.0}, f"{QUERY} -i 0,1,2,3"),
    (["NVIDIA H100 80GB HBM3"], "3,-1,2",
     {"GPU": 1.0, "GPU-H100": 1.0}, f"{QUERY} -i 3"),
    (["NVIDIA A100-SXM4-80GB"], "1", {"GPU": 1.0, "GPU-A100": 1.0},
     f"{QUERY} -i 1"),
    (["NVIDIA H100 80GB HBM3", "NVIDIA A100-SXM4-40GB"], "0,1",
     {"GPU": 2.0, "GPU-H100": 1.0, "GPU-A100": 1.0}, f"{QUERY} -i 0,1"),
    (["NVIDIA H100 80GB HBM3"] * 2, None,
     {"GPU": 2.0, "GPU-H100": 2.0}, QUERY),
])
def test_model_key_from_nvidia_smi(smi, monkeypatch, cards, visible, want,
                                   call):
    smi(*cards)
    if visible is None:
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    else:
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    assert GPUAcceleratorManager.node_resources() == want
    assert smi.calls()[-1] == call


def test_named_count_keeps_the_plain_shape(smi, monkeypatch):
    smi("NVIDIA H100 80GB HBM3")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    assert GPUAcceleratorManager.node_resources(2) == {"GPU": 2.0}
    assert GPUAcceleratorManager.node_resources(0) == {}
    assert smi.calls() == []


def test_no_model_key_without_a_name(smi, monkeypatch):
    """nvidia-smi failing or missing, or no card visible: the count
    alone (or nothing)."""
    smi("NVIDIA H100 80GB HBM3")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    monkeypatch.setenv("FAKE_SMI_RC", "9")
    assert GPUAcceleratorManager.node_resources() == {"GPU": 1.0}
    monkeypatch.setenv("PATH", "/nonexistent")
    assert GPUAcceleratorManager.node_resources() == {"GPU": 1.0}
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert GPUAcceleratorManager.node_resources() == {}


@pytest.mark.parametrize("name,model", [
    ("NVIDIA H100 80GB HBM3", "H100"), ("NVIDIA H100 PCIe", "H100"),
    ("NVIDIA A100-SXM4-80GB", "A100"), ("Tesla V100-SXM2-16GB", "V100"),
    ("NVIDIA L4", "L4")])
def test_model_parsing(smi, monkeypatch, name, model):
    smi(name)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    assert GPUAcceleratorManager.model_counts() == {model: 1}


def test_providers_import_neither_torch_nor_jax():
    code = ("import sys\n"
            "import ray_tpu_torch.providers\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'ray_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
