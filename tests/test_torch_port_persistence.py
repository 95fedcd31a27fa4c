"""The port's storage providers and RESP client (``dreamlab_tpu_torch.persistence``,
``utils/resp.py``) on ``tests/test_persistence.py``'s cases, against the same
in-process fake Redis speaking RESP over a socket; and each filesystem and
Redis entry written by one package read back by the other."""

import time

import pytest

from dreamlab_tpu.persistence import FilesystemStorageProvider as JaxFilesystem
from dreamlab_tpu.persistence.redis_provider import RedisStorageProvider as JaxRedis
from dreamlab_tpu_torch.persistence import (FilesystemStorageProvider, InMemoryStorageProvider,
                                            make_storage_provider_from_env)
from dreamlab_tpu_torch.persistence.redis_provider import RedisStorageProvider
from dreamlab_tpu_torch.utils.resp import RespClient, RespError
from tests.test_persistence import FakeRedis


@pytest.fixture(scope="module")
def fake_redis():
    srv = FakeRedis()
    srv.start()
    yield srv
    srv.stop()


def test_memory_put_get_delete():
    p = InMemoryStorageProvider()
    key = p.new_key()
    assert key.startswith("lcm:")
    p.put(key, b"abc", {"seed": "1"}, content_type="image/png")
    item = p.get(key)
    assert (item.data, item.metadata, item.content_type) == (b"abc", {"seed": "1"}, "image/png")
    assert p.delete(key)
    assert p.get(key) is None
    assert not p.delete(key)


def test_memory_ttl_expiry():
    p = InMemoryStorageProvider(default_ttl=0.05)
    p.put("k", b"v")
    assert p.get("k") is not None
    time.sleep(0.08)
    assert p.get("k") is None


def test_memory_drop_oldest():
    p = InMemoryStorageProvider(max_items=2, default_ttl=None)
    p.put("a", b"1")
    time.sleep(0.01)
    p.put("b", b"2")
    time.sleep(0.01)
    p.put("c", b"3")
    assert p.get("a") is None
    assert p.get("b") and p.get("c")


def test_memory_health():
    p = InMemoryStorageProvider()
    p.put("k", b"xyz")
    h = p.health()
    assert h == {"provider": "memory", "ok": True, "entries": 1, "bytes": 3}


def test_fs_roundtrip(tmp_path):
    p = FilesystemStorageProvider(str(tmp_path / "store"), cleanup_interval=3600)
    p.put("k1", b"data", {"a": "b"}, content_type="image/png")
    item = p.get("k1")
    assert item.data == b"data" and item.metadata == {"a": "b"}
    assert p.health()["entries"] == 1
    assert p.delete("k1")
    assert p.get("k1") is None
    p.close()


def test_fs_ttl_cleanup(tmp_path):
    p = FilesystemStorageProvider(str(tmp_path / "store"), default_ttl=0.01,
                                  cleanup_interval=3600)
    p.put("k", b"v")
    time.sleep(0.05)
    assert p.get("k") is None  # lazy expiry on read
    p.put("k2", b"v", ttl=0.01)
    time.sleep(0.05)
    assert p.cleanup_expired() >= 1
    p.close()


@pytest.mark.parametrize("writer_cls,reader_cls", [(JaxFilesystem, FilesystemStorageProvider),
                                                   (FilesystemStorageProvider, JaxFilesystem)])
def test_fs_layout_is_the_jax_packages(tmp_path, writer_cls, reader_cls):
    root = str(tmp_path / "store")
    writer = writer_cls(root, cleanup_interval=3600)
    writer.put("lcm:x", b"\x89PNG", {"seed": "7"}, content_type="image/png")
    reader = reader_cls(root, cleanup_interval=3600)
    item = reader.get("lcm:x")
    assert (item.data, item.metadata, item.content_type) == (b"\x89PNG", {"seed": "7"},
                                                             "image/png")
    assert reader.health()["entries"] == writer.health()["entries"] == 1
    writer.close()
    reader.close()


def test_env_factory(tmp_path, monkeypatch):
    monkeypatch.setenv("STORAGE_PROVIDER", "DISABLED")
    assert make_storage_provider_from_env() is None
    monkeypatch.setenv("STORAGE_PROVIDER", "MEMORY")
    assert isinstance(make_storage_provider_from_env(), InMemoryStorageProvider)
    monkeypatch.setenv("STORAGE_PROVIDER", "FILESYSTEM")
    monkeypatch.setenv("FS_STORAGE_ROOT", str(tmp_path / "fs"))
    prov = make_storage_provider_from_env()
    assert isinstance(prov, FilesystemStorageProvider)
    prov.close()
    monkeypatch.setenv("STORAGE_PROVIDER", "REDIS")
    monkeypatch.setenv("REDIS_PORT", "1")  # nothing listens there: memory instead
    assert isinstance(make_storage_provider_from_env(), InMemoryStorageProvider)
    monkeypatch.setenv("STORAGE_PROVIDER", "S3")
    with pytest.raises(ValueError, match="S3"):
        make_storage_provider_from_env()


def test_resp_client_basics(fake_redis):
    c = RespClient(port=fake_redis.port)
    assert c.ping()
    c.set("x", b"hello", ex=100)
    assert c.get("x") == b"hello"
    assert c.delete("x") == 1
    assert c.get("x") is None
    c.hset("h", {"f1": "v1", "f2": "v2"})
    assert c.hgetall("h") == {b"f1": b"v1", b"f2": b"v2"}
    c.zadd("z", {"a": 1.0, "b": 3.0, "c": 2.0})
    assert c.zrevrange("z", 0, -1) == [b"b", b"c", b"a"]
    assert c.zrevrange("z", 0, 0, withscores=True) == [(b"b", 3.0)]
    assert c.zcard("z") == 3
    with pytest.raises(RespError):
        c.command(b"NOSUCHCOMMAND")
    c.close()


def test_redis_provider_roundtrip(fake_redis):
    p = RedisStorageProvider(port=fake_redis.port)
    p.put("img:1", b"\x89PNG", {"seed": "7"}, content_type="image/png", ttl=60)
    item = p.get("img:1")
    assert (item.data, item.metadata, item.content_type) == (b"\x89PNG", {"seed": "7"},
                                                             "image/png")
    assert p.health()["ok"]
    # the JAX provider reads what the port's wrote, on the same server
    jitem = JaxRedis(port=fake_redis.port).get("img:1")
    assert (jitem.data, jitem.metadata, jitem.content_type) == (item.data, item.metadata,
                                                                item.content_type)
    assert p.delete("img:1")
    assert p.get("img:1") is None
    p.close()


def test_redis_provider_fails_fast_when_down():
    with pytest.raises(OSError):
        RedisStorageProvider(port=1)  # nothing listens there
