"""The port's s3.* shell family against the JAX package's, and the port's
gateway reloading its identities live.

Each package runs its cluster, filer and S3 gateway (no identities at the
start: anonymous access) in this process, as ``tests/test_shell_s3.py``
does. The same shell commands run against both and must print the same
text: ``s3.bucket.create``, ``s3.bucket.list``, ``s3.bucket.delete``
(namespace and collection gone), ``s3.configure`` with its edits,
``-delete`` and ``-apply``, and the refusal of an unknown action. After
``s3.configure -apply`` each gateway reloads ``/etc/iam/identity.json``
through its metadata subscription (waited for, never slept on): then
anonymous requests get 403 and signed ones 200, in both. ``fs.configure``
applies live in both filers, as in the JAX test.
"""

import json
import urllib.error
import urllib.request

import pytest

from seaweedfs_tpu.filer import http_client as jax_http
from seaweedfs_tpu.s3api import S3ApiServer as JaxS3
from seaweedfs_tpu.shell import CommandError as JaxCommandError
from seaweedfs_tpu.shell import Shell as JaxShell
from seaweedfs_tpu_torch.filer import http_client as port_http
from seaweedfs_tpu_torch.s3api import S3ApiServer as PortS3
from seaweedfs_tpu_torch.shell import CommandError as PortCommandError
from seaweedfs_tpu_torch.shell import Shell as PortShell
from tests.test_torch_cluster import free_port_pair, wait_for
from tests.test_torch_filer_server import make_sides
from tests.test_torch_s3 import IDENTITIES, raw_request, sign_v4


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    sides, undo = make_sides(tmp_path_factory)
    gws = {}
    try:
        for name, cls in (("jax", JaxS3), ("port", PortS3)):
            gws[name] = cls(filer_url=sides[name].filer.url,
                            port=free_port_pair())
            gws[name].start()
        shells = {"jax": JaxShell(sides["jax"].cluster.master.url,
                                  filer_url=sides["jax"].filer.url),
                  "port": PortShell(sides["port"].cluster.master.url,
                                    filer_url=sides["port"].filer.url)}
        yield sides, gws, shells
    finally:
        for g in gws.values():
            g.stop()
        for s in sides.values():
            s.stop()
        undo()


def run_both(shells, line):
    out = {n: sh.run_command(line) for n, sh in shells.items()}
    assert out["port"] == out["jax"], line
    return out["port"]


def test_bucket_create_list_delete(env):
    sides, _, shells = env
    assert "created bucket shelly" in run_both(
        shells, "s3.bucket.create -name shelly -replication 000")
    assert "shelly" in run_both(shells, "s3.bucket.list")
    for name, sh in shells.items():
        e = sh.env.filer_entry("/buckets/shelly")
        assert e.is_directory and e.attributes.collection == "shelly"
        assert e.attributes.replication == "000"
    # delete drops both the namespace and the collection
    for name, mod in (("jax", jax_http), ("port", port_http)):
        mod.put(sides[name].filer.url, "/buckets/shelly/x.txt", b"hi")
    assert "deleted bucket shelly" in run_both(
        shells, "s3.bucket.delete -name shelly")
    assert "shelly" not in run_both(shells, "s3.bucket.list")
    for name, sh in shells.items():
        assert sh.env.filer_entry("/buckets/shelly") is None
        assert not any(v.collection == "shelly"
                       for vs in sides[name].cluster.volume_servers
                       for loc in vs.store.locations
                       for v in loc.volumes.values())


def _status(url, path, who=None):
    headers = {}
    if who:
        access, secret, _ = IDENTITIES[who]
        headers, _, _, _ = sign_v4(url, "GET", path, "", {}, b"", access,
                                   secret)
    return raw_request(url, "GET", path, headers=headers)[0]


def test_s3_configure_round_trip_and_live_reload(env):
    sides, gws, shells = env
    for g in gws.values():
        assert _status(g.url, "/") == 200        # no identities: open
    access, secret, _ = IDENTITIES["admin"]
    out = run_both(shells, f"s3.configure -user admin -access_key {access} "
                           f"-secret_key {secret} -actions Admin -apply")
    doc = json.loads(out.split("applied")[0])
    assert doc["identities"][0]["credentials"][0]["accessKey"] == access
    for name, mod in (("jax", jax_http), ("port", port_http)):
        status, body, _ = mod.get(sides[name].filer.url,
                                  "/etc/iam/identity.json")
        assert status == 200 and json.loads(body) == doc
    for g in gws.values():
        wait_for(lambda: g.iam.is_enabled, what="the gateway's iam reload")
    assert {n: (_status(g.url, "/"), _status(g.url, "/", "admin"))
            for n, g in gws.items()} == {"jax": (403, 200),
                                         "port": (403, 200)}
    # a second apply reloads again: the new user is known at once after
    out = run_both(shells, "s3.configure -user r -access_key "
                           f"{IDENTITIES['reader'][0]} -secret_key "
                           f"{IDENTITIES['reader'][1]} -actions Read -apply")
    for g in gws.values():
        wait_for(lambda: len(g.iam.identities) == 2,
                 what="the second reload")
        assert _status(g.url, "/", "reader") == 403     # Read lists nothing
    run_both(shells, "s3.configure -user r -delete -apply")
    for g in gws.values():
        wait_for(lambda: len(g.iam.identities) == 1, what="the third reload")


def test_s3_configure_edit_and_delete(env):
    _, _, shells = env
    run_both(shells, "s3.configure -user bob -access_key BK -secret_key BS "
                     "-actions Read,Write -buckets b1 -apply")

    def bob():
        doc = json.loads(run_both(shells, "s3.configure").rsplit("}", 1)[0]
                         + "}")
        return next((i for i in doc["identities"] if i["name"] == "bob"),
                    None)

    assert set(bob()["actions"]) == {"Read:b1", "Write:b1"}
    run_both(shells, "s3.configure -user bob -actions Write -buckets b1 "
                     "-delete -apply")
    assert bob()["actions"] == ["Read:b1"]
    run_both(shells, "s3.configure -user bob -access_key BK -delete")
    run_both(shells, "s3.configure -user bob -delete -apply")
    assert bob() is None


def test_s3_configure_refusals_answer_alike(env):
    _, _, shells = env
    for line in ("s3.configure -user x -actions Fly",
                 "s3.configure -user ghost -delete -access_key K"):
        errs = []
        for sh, exc in ((shells["jax"], JaxCommandError),
                        (shells["port"], PortCommandError)):
            with pytest.raises(exc) as ei:
                sh.run_command(line)
            errs.append(str(ei.value))
        assert errs[0] == errs[1]
    assert "unknown action" in errs[0] or "no such user" in errs[0]


def test_fs_configure_rule_applies_live(env):
    sides, _, shells = env
    assert "applied" in run_both(
        shells, "fs.configure -locationPrefix /confd/ -collection special "
                "-fsync -apply")
    for s in sides.values():
        wait_for(lambda: s.filer.filer_conf.match("/confd/a") is not None,
                 what="the filer reloads filer.conf")
        rule = s.filer.filer_conf.match("/confd/a")
        assert rule.collection == "special" and rule.fsync
    assert "/confd/" in run_both(shells, "fs.configure")
    run_both(shells, "fs.configure -locationPrefix /confd/ -delete -apply")
    for s in sides.values():
        wait_for(lambda: s.filer.filer_conf.match("/confd/a") is None,
                 what="the rule removed")


def test_anonymous_reads_before_configure_only(env):
    """urllib against each gateway: the JAX test's open-access probe."""
    _, gws, _ = env
    for g in gws.values():
        if g.iam.is_enabled:
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(f"http://{g.url}/", timeout=10)
            assert ei.value.code == 403
        else:
            assert urllib.request.urlopen(f"http://{g.url}/",
                                          timeout=10).status == 200
