"""The input cache: one seed's files are written once, synced, and found
by later runs of the seed; a directory cut short is made anew; the
least recently used seeds beyond the cache's size are removed."""
import os

from benchmark import inputs


def test_made_once_then_found(tmp_path):
    made = []

    def fill(d):
        made.append(d)
        with open(os.path.join(d, "a.bin"), "wb") as f:
            f.write(b"x" * 10)

    path = str(tmp_path / inputs.cache_key("cell", 7, {"n": 1}, {"b": 2}))
    assert inputs.cached_dir(path, fill) is False
    assert inputs.cached_dir(path, fill) is True
    assert len(made) == 1 and made[0] == path + ".part"
    assert open(os.path.join(path, "a.bin"), "rb").read() == b"x" * 10
    assert not os.path.exists(path + ".part")


def test_key_follows_sizes_and_seed():
    k = inputs.cache_key("cell", 7, {"n": 1}, {"b": 2})
    assert k == inputs.cache_key("cell", 7, {"n": 1}, {"b": 2})
    assert k != inputs.cache_key("cell", 8, {"n": 1}, {"b": 2})
    assert k != inputs.cache_key("cell", 7, {"n": 2}, {"b": 2})


def test_part_left_over_is_made_anew(tmp_path):
    path = str(tmp_path / "k")
    os.makedirs(path + ".part")
    open(os.path.join(path + ".part", "stale"), "w").close()
    inputs.cached_dir(path, lambda d: open(os.path.join(d, "new"), "w")
                      .close())
    assert os.listdir(path) == ["new"]


def test_least_recently_used_removed(tmp_path):
    paths = [str(tmp_path / f"s{i}") for i in range(4)]
    for i, p in enumerate(paths[:3]):
        inputs.cached_dir(p, lambda d: None, keep=3)
        os.utime(p, (i, i))
    inputs.cached_dir(paths[0], lambda d: None, keep=3)   # used again
    inputs.cached_dir(paths[3], lambda d: None, keep=3)
    assert sorted(os.listdir(tmp_path)) == ["s0", "s2", "s3"]
