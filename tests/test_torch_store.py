"""The port's TCPStore, rendezvous and TCPKVStore
(``paddle_tpu_torch.distributed.store``), held to the cases of the JAX
package's ``test_store.py`` and to the reference's wire protocol: a port
client against the reference's ``_StoreServer``, and a reference client
against the port's server.  Host-side code: neither store imports jax."""

import threading
import time

import pytest

from paddle_tpu.distributed import store as ref_store
from paddle_tpu_torch.distributed.store import (TCPKVStore, TCPStore, rendezvous,
                                                _host_is_local)


@pytest.fixture
def master():
    s = TCPStore("127.0.0.1", 0, is_master=True, world_size=2, timeout=20.0)
    yield s
    s.close()


class TestTCPStore:
    def test_set_get_roundtrip(self, master):
        client = TCPStore("127.0.0.1", master.port, timeout=10.0)
        master.set("alpha", b"one")
        assert client.get("alpha") == b"one"
        client.set("beta", "two")  # str is encoded
        assert master.get("beta") == b"two"
        client.close()

    def test_add_is_atomic_across_clients(self, master):
        clients = [TCPStore("127.0.0.1", master.port, timeout=10.0)
                   for _ in range(4)]
        results = []

        def bump(c):
            for _ in range(25):
                results.append(c.add("ctr", 1))

        threads = [threading.Thread(target=bump, args=(c,)) for c in clients]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert sorted(results) == list(range(1, 101))
        for c in clients:
            c.close()

    def test_wait_blocks_until_set(self, master):
        client = TCPStore("127.0.0.1", master.port, timeout=10.0)

        def later():
            time.sleep(0.2)
            master.set("slow", b"v")

        threading.Thread(target=later).start()
        t0 = time.time()
        client.wait(["slow"], timeout=5.0)
        assert time.time() - t0 >= 0.1
        client.close()

    def test_compare_set_and_delete(self, master):
        master.set("k", b"a")
        assert master.compare_set("k", b"a", b"b") == b"b"
        assert master.compare_set("k", b"a", b"c") == b"b"  # mismatch: unchanged
        assert master.delete_key("k") is True
        assert master.delete_key("k") is False

    def test_timeout_does_not_desync_protocol(self, master):
        """Round-3 review regression: a timed-out get() must not leave a
        stale reply in the stream that the next command reads as its own."""
        client = TCPStore("127.0.0.1", master.port, timeout=10.0)
        with pytest.raises(TimeoutError):
            client.get("missing", timeout=0.3)
        # next calls see a clean stream
        client.set("present", b"yes")
        assert client.get("present", timeout=5.0) == b"yes"
        assert client.num_keys() >= 1
        client.close()

    def test_barrier_timeout_race_does_not_corrupt_next_generation(
            self, master):
        """Regression: a waiter whose cond.wait times out JUST AFTER the
        releasing arrival bumped the generation must count as released —
        the old code decremented the NEW generation's arrived count (to −1)
        and desynced every later barrier on that key."""
        server = master._server
        result = {}

        def waiter():
            c = TCPStore("127.0.0.1", master.port, timeout=10.0)
            try:
                c.barrier("race", 2, timeout=0.5)
                result["ok"] = True
            except TimeoutError:
                result["ok"] = False
            finally:
                c.close()

        t = threading.Thread(target=waiter)
        t.start()
        time.sleep(0.2)  # waiter is parked in cond.wait
        with server._cond:
            # hold the lock PAST the waiter's deadline (its wait() expires
            # but cannot reacquire), then emulate the releasing second
            # arrival — exactly the race window
            time.sleep(0.6)
            b = server._barriers["race"]
            b["arrived"] = 0
            b["gen"] += 1
            b["ranks"] = set()
            server._cond.notify_all()
        t.join(5)
        assert result["ok"] is True  # released, not timed out
        assert server._barriers["race"]["arrived"] == 0  # not −1
        # the NEXT generation still releases both members
        done = []

        def member():
            c = TCPStore("127.0.0.1", master.port, timeout=10.0)
            c.barrier("race", 2, timeout=5.0)
            done.append(1)
            c.close()

        t2 = threading.Thread(target=member)
        t2.start()
        master.barrier("race", 2, timeout=5.0)
        t2.join(5)
        assert done == [1]

    def test_barrier_timeout_names_missing_ranks(self, master):
        with pytest.raises(TimeoutError) as ei:
            master.barrier("who", world_size=3, timeout=0.4, rank=1)
        msg = str(ei.value)
        assert "missing ranks" in msg
        assert "[0, 2]" in msg  # the ranks that never arrived, not ours

    def test_barrier_timeout_without_rank_keeps_count_message(self, master):
        with pytest.raises(TimeoutError) as ei:
            master.barrier("anon", world_size=4, timeout=0.3)
        assert "1/4" in str(ei.value)

    def test_barrier_releases_all(self, master):
        done = []

        def member():
            c = TCPStore("127.0.0.1", master.port, world_size=2, timeout=10.0)
            c.barrier("b0", 2, timeout=10.0)
            done.append(1)
            c.close()

        t = threading.Thread(target=member)
        t.start()
        time.sleep(0.1)
        assert not done  # second member not there yet
        master.barrier("b0", 2, timeout=10.0)
        t.join(10.0)
        assert done == [1]


SERVER_SCRIPT = """
import importlib.util, sys, time
# load store.py standalone (stdlib-only module): no package import
spec = importlib.util.spec_from_file_location("store_mod", sys.argv[1])
m = importlib.util.module_from_spec(spec)
spec.loader.exec_module(m)
s = m.TCPStore("127.0.0.1", int(sys.argv[2]), is_master=True)
print("ready", flush=True)
time.sleep(600)
"""


JOIN_SCRIPT = """
import importlib.util, sys
spec = importlib.util.spec_from_file_location("store_mod", sys.argv[1])
m = importlib.util.module_from_spec(spec)
spec.loader.exec_module(m)
store, rank = m.rendezvous(sys.argv[2], 2, job_id="j1", timeout=20.0)
print(rank, store.get(f"j1/node/{rank}") is not None, flush=True)
store.close()
"""


class TestTransparentRetry:
    """A master blip (kill + restart of the store server) must not kill
    rendezvous: idempotent commands reconnect and retry the in-flight
    request once; non-idempotent commands (add/barrier) still fail fast."""

    @staticmethod
    def _spawn_server(tmp_path, port):
        import os
        import subprocess
        import sys as _sys

        store_py = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "paddle_tpu_torch", "distributed", "store.py")
        script = tmp_path / "server.py"
        script.write_text(SERVER_SCRIPT)
        proc = subprocess.Popen(
            [_sys.executable, str(script), store_py, str(port)],
            stdout=subprocess.PIPE, text=True)
        assert proc.stdout.readline().strip() == "ready"
        return proc

    def test_idempotent_calls_survive_server_kill_and_restart(self, tmp_path):
        import socket as _socket

        # reserve a port, then hand it to the server subprocess
        probe = _socket.socket()
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
        probe.close()

        srv1 = self._spawn_server(tmp_path, port)
        client = TCPStore("127.0.0.1", port, timeout=15.0)
        try:
            client.set("k1", b"v1")
            assert client.get("k1") == b"v1"

            srv1.kill()
            srv1.wait(timeout=10)
            srv2 = self._spawn_server(tmp_path, port)
            try:
                # set/get transparently reconnect + resend (one retry);
                # the restarted master has empty state — that's the
                # rendezvous re-registration story, not the client's
                client.set("k2", b"v2")
                assert client.get("k2", timeout=10.0) == b"v2"
                assert "k1" not in client.keys()

                # non-idempotent commands are NOT replayed: a blip mid-add
                # surfaces (after reconnecting) instead of double-counting
                srv2.kill()
                srv2.wait(timeout=10)
                srv3 = self._spawn_server(tmp_path, port)
                try:
                    with pytest.raises(TimeoutError):
                        client.add("ctr", 1)
                    # the reconnect left a clean stream: the NEXT add works
                    assert client.add("ctr", 1) == 1
                finally:
                    srv3.kill()
            finally:
                if srv2.poll() is None:
                    srv2.kill()
        finally:
            client.close()
            if srv1.poll() is None:
                srv1.kill()


class TestRendezvous:
    def test_host_is_local(self):
        assert _host_is_local("127.0.0.1")
        assert _host_is_local("localhost")
        assert _host_is_local("")
        # a host that resolves elsewhere must NOT be electable
        assert not _host_is_local("192.0.2.1")  # TEST-NET, never local

    def test_two_node_rendezvous_without_shared_fs(self):
        """Two pods rendezvous over TCP only.  One process on the master
        host wins the bind race and hosts the store (here: the parent, at an
        OS-assigned port); two worker processes, each loading the port's
        store.py standalone (no fork of this multi-threaded process), then
        run the rendezvous protocol against it."""
        import os
        import subprocess
        import sys as _sys

        host_store = TCPStore("127.0.0.1", 0, is_master=True, world_size=2,
                              timeout=20.0)
        store_py = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "paddle_tpu_torch", "distributed", "store.py")
        procs = [subprocess.Popen([_sys.executable, "-c", JOIN_SCRIPT, store_py,
                                   f"127.0.0.1:{host_store.port}"],
                                  stdout=subprocess.PIPE, text=True) for _ in range(2)]
        try:
            got = [p.communicate(timeout=30)[0].split() for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            host_store.close()
        assert all(p.returncode == 0 for p in procs)
        assert sorted(int(r) for r, _ in got) == [0, 1]
        assert all(ok == "True" for _, ok in got)


class TestTCPKVStore:
    def test_elastic_kv_interface(self, master):
        kv = TCPKVStore(TCPStore("127.0.0.1", master.port, timeout=10.0))
        kv.put("node/0", {"host": "a"})
        kv.put("node/1", {"host": "b"})
        assert kv.get("node/0") == {"host": "a"}
        assert kv.get("nope") is None
        assert sorted(kv.keys("node/")) == ["node/0", "node/1"]
        assert kv.age("node/0") < 5.0
        kv.touch("node/0")
        kv.delete("node/1")
        assert kv.keys("node/") == ["node/0"]


PACKAGES = {"port": TCPStore, "ref": ref_store.TCPStore}


@pytest.mark.parametrize("server,client", [("ref", "port"), ("port", "ref")])
class TestWireCompatibility:
    """A client of one package against the server of the other: every
    command of the protocol, blocking ones and timeouts included."""

    def test_every_command(self, server, client):
        host = PACKAGES[server]("127.0.0.1", 0, is_master=True, world_size=2,
                                timeout=20.0)
        c = PACKAGES[client]("127.0.0.1", host.port, world_size=2, timeout=10.0)
        try:
            c.set("k", b"\x00\xffbytes")
            assert host.get("k") == b"\x00\xffbytes"
            host.set("s", "text")
            assert c.get("s") == b"text"
            assert [c.add("n", 2), host.add("n", 3), c.add("n", -1)] == [2, 5, 4]
            assert c.compare_set("k", b"\x00\xffbytes", "new") == b"new"
            assert c.compare_set("k", "old", "other") == b"new"
            assert c.compare_set("fresh", "", "v") == b"v"
            assert sorted(c.keys()) == ["fresh", "k", "n", "s"] and c.num_keys() == 4
            assert c.keys("f") == ["fresh"]
            assert 0.0 <= c.age("k") < 5.0 and c.age("missing") is None
            assert c.delete_key("k") is True and c.delete_key("k") is False
            with pytest.raises(TimeoutError):
                c.get("missing", timeout=0.3)
            assert c.get("s", timeout=5.0) == b"text"     # the stream stays in step

            threading.Timer(0.2, lambda: host.set("late", b"1")).start()
            c.wait(["late", "s"], timeout=5.0)

            done = []
            t = threading.Thread(target=lambda: (c.barrier("b", 2, timeout=10.0, rank=1),
                                                 done.append(1)))
            t.start()
            time.sleep(0.1)
            assert not done
            host.barrier("b", 2, timeout=10.0, rank=0)
            t.join(10.0)
            assert done == [1] and not t.is_alive()
            with pytest.raises(TimeoutError, match=r"missing ranks \[0, 2\]"):
                c.barrier("who", world_size=3, timeout=0.4, rank=1)

            kv = TCPKVStore(c)
            kv.put("node/0", {"host": "a"})
            assert ref_store.TCPKVStore(host).get("node/0") == {"host": "a"}
        finally:
            c.close()
            host.close()

    def test_rendezvous_through_the_other_server(self, server, client):
        host = PACKAGES[server]("127.0.0.1", 0, is_master=True, world_size=2,
                                timeout=20.0)
        join = rendezvous if client == "port" else ref_store.rendezvous
        addr = f"127.0.0.1:{host.port}"
        got = []

        def node():
            store, rank = join(addr, 2, job_id="x", timeout=20.0)
            got.append((rank, store.get(f"x/node/{rank}")))
            store.close()

        threads = [threading.Thread(target=node) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30.0)
        host.close()
        assert not any(t.is_alive() for t in threads)
        assert sorted(r for r, _ in got) == [0, 1] and all(h for _, h in got)
