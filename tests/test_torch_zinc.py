"""The port's ZINC acquisition helpers (bbbp_tpu_torch/data/zinc.py) against
bbbp_tpu/data/zinc.py: the wget-script parser, the substance URL, the
per-ID downloader and the threaded bulk fetch give the same results on the
same inputs (tolerance 0: the functions are copies).

No test reaches the network: ``urllib.request.urlopen`` is replaced by a
fake that serves canned bodies by URL, and every socket connection or name
lookup is refused and recorded while a test runs."""

import ast
import csv
import os
import socket
import threading
import urllib.error
import urllib.request

import pytest

import bbbp_tpu.data.zinc as jzinc
import bbbp_tpu_torch.data.zinc as tzinc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPIED = ("parse_wget_list", "zinc_substance_url", "download_molecule",
          "download_dataset")
BOTH = (jzinc, tzinc)


@pytest.fixture(autouse=True)
def no_network(monkeypatch):
    """Refuses and records any connection or name lookup."""
    attempts = []

    def refuse(name):
        def _refused(*a, **k):
            attempts.append((name, a[:2]))
            raise OSError(f"network refused in tests: {name}")
        return _refused

    monkeypatch.setattr(socket.socket, "connect", refuse("connect"))
    monkeypatch.setattr(socket.socket, "connect_ex", refuse("connect_ex"))
    monkeypatch.setattr(socket, "create_connection", refuse("create_connection"))
    monkeypatch.setattr(socket, "getaddrinfo", refuse("getaddrinfo"))
    yield attempts
    assert attempts == []


def _url(zid, fmt="smi"):
    return f"https://zinc15.docking.org/substances/{zid}.{fmt}"


# canned bodies by URL: the fake raises the exceptions
BODIES = {
    _url("ZINC000000000001"): b"CCO ZINC000000000001\n",
    _url("ZINC000000000002"): b"  c1ccccc1\tzinc000000000002  \n",
    _url("ZINC000000000003"): b"CCN 000000000003\n",              # echo without ZINC
    _url("ZINC000000000004"): b"CCCC\n",                          # one token
    _url("ZINC000000000005"): urllib.error.URLError("unreachable"),
    _url("ZINC000000000006"): TimeoutError("timed out"),
    _url("ZINC000000000007"): b"C[N+](C)(C)C.[Cl-] ZINC000000000007 extra\n",
    _url("ZINC000000000008"): b"",
    _url("ZINC000000000009"): b"O=C=O \xff\xfeZINC9\n",           # not utf-8
    _url("ZINC000000000010", "sdf"): b"CCO ZINC000000000010\n",
    _url("ZINC000000000011"): urllib.error.HTTPError(
        _url("ZINC000000000011"), 404, "Not Found", {}, None),
}
IDS = ["ZINC000000000001", "2", "zinc000000000003", " 4 ", "ZINC000000000005",
       "6", "ZINC000000000007", "8", "9", "11", "ZINC000000000099"]


class _Response:
    def __init__(self, body):
        self.body = body

    def read(self):
        return self.body

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.fixture
def fake_urlopen(monkeypatch):
    """Serves ``BODIES``; an unknown URL raises a 404 ``HTTPError``. Records
    every (url, timeout) it was called with."""
    calls = []
    lock = threading.Lock()

    def urlopen(url, timeout=None, **kw):
        with lock:
            calls.append((url, timeout))
        body = BODIES.get(url)
        if body is None:
            raise urllib.error.HTTPError(url, 404, "Not Found", {}, None)
        if isinstance(body, BaseException):
            raise body
        return _Response(body)

    monkeypatch.setattr(urllib.request, "urlopen", urlopen)
    return calls


def _defs(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    return {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}


@pytest.mark.parametrize("name", COPIED)
def test_function_is_a_copy(name):
    jdefs = _defs(os.path.join(REPO, "bbbp_tpu", "data", "zinc.py"))
    tdefs = _defs(os.path.join(REPO, "bbbp_tpu_torch", "data", "zinc.py"))
    assert ast.dump(jdefs[name]) == ast.dump(tdefs[name])


def test_module_imports_no_urllib_at_top_level():
    with open(os.path.join(REPO, "bbbp_tpu_torch", "data", "zinc.py")) as f:
        tree = ast.parse(f.read())
    top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
    names = [a.name for n in top if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in top if isinstance(n, ast.ImportFrom)]
    assert not [n for n in names if n.startswith("urllib")], names


WGET_SCRIPTS = {
    "plain": ("mkdir -pv FE\n"
              "wget http://files.docking.org/2D/FE/FEAA.smi -O FE/FEAA.smi\n"
              "wget https://files.docking.org/2D/FE/FEAB.smi -O FE/FEAB.smi\n"),
    "quoted": ('wget "https://files.docking.org/2D/AA/AAAA.smi" -O AA/AAAA.smi\n'
               "wget 'http://files.docking.org/2D/AB/ABAA.smi'\n"
               'curl -o x.smi "https://files.docking.org/2D/AC/ACAA.smi"\n'),
    "blank_lines": ("\n\n   \n"
                    "wget -c --tries=3 http://files.docking.org/2D/BA/BAAA.smi\n"
                    "\n\t\n"
                    "wget\thttps://files.docking.org/2D/BB/BBAA.smi\t-O\tBB.smi\n\n"),
    "no_urls": "#!/bin/sh\nmkdir -pv AA\necho ftp://not.http/x\nwget -O a.smi\n",
    "empty": "",
    "two_a_line": ("wget http://a.example/x.smi https://b.example/y.smi "
                   "-O 'http-not-a-url.smi' HTTPS://upper.example/z.smi\n"),
}


@pytest.mark.parametrize("script", sorted(WGET_SCRIPTS))
def test_parse_wget_list_equals_jax(tmp_path, script):
    p = tmp_path / "ZINC-downloader-2D-smi.wget"
    p.write_text(WGET_SCRIPTS[script])
    theirs = jzinc.parse_wget_list(str(p))
    assert tzinc.parse_wget_list(str(p)) == theirs
    if script == "plain":
        assert theirs == ["http://files.docking.org/2D/FE/FEAA.smi",
                          "https://files.docking.org/2D/FE/FEAB.smi"]
    if script in ("no_urls", "empty"):
        assert theirs == []


def test_zinc_formats_equal_jax():
    assert tzinc.ZINC_FORMATS == jzinc.ZINC_FORMATS


@pytest.mark.parametrize("fmt", jzinc.ZINC_FORMATS)
@pytest.mark.parametrize("zid", ["ZINC000000000001", "ZINC1", "zinc42", "  ZINC7\n",
                                 "42", " 42 ", "0", "000123", "123456789012",
                                 "\tzinc000012345678 "])
def test_zinc_substance_url_equals_jax(zid, fmt):
    theirs = jzinc.zinc_substance_url(zid, fmt)
    assert tzinc.zinc_substance_url(zid, fmt) == theirs
    assert theirs.startswith("https://zinc15.docking.org/substances/ZINC")
    assert theirs.endswith("." + fmt)


@pytest.mark.parametrize("zid", ["abc", "", "4.2"])
def test_zinc_substance_url_raises_as_jax(zid):
    with pytest.raises(ValueError):
        jzinc.zinc_substance_url(zid)
    with pytest.raises(ValueError):
        tzinc.zinc_substance_url(zid)


@pytest.mark.parametrize("zid,fmt", [(z, "smi") for z in IDS] + [("10", "sdf"),
                                                                  ("1", "sdf")])
def test_download_molecule_equals_jax(fake_urlopen, zid, fmt):
    theirs = jzinc.download_molecule(zid, fmt, timeout=3.0)
    ours = tzinc.download_molecule(zid, fmt, timeout=3.0)
    assert ours == theirs
    assert fake_urlopen == [(jzinc.zinc_substance_url(zid, fmt), 3.0)] * 2


def test_download_molecule_results(fake_urlopen):
    """The ID echo check and None on any error, as the JAX function has them."""
    got = {z: tzinc.download_molecule(z) for z in IDS}
    assert got == {
        "ZINC000000000001": ("ZINC000000000001", "CCO"),
        "2": ("zinc000000000002", "c1ccccc1"),
        "zinc000000000003": None, " 4 ": None, "ZINC000000000005": None,
        "6": None,
        "ZINC000000000007": ("ZINC000000000007", "C[N+](C)(C)C.[Cl-]"),
        "8": None, "9": None, "11": None, "ZINC000000000099": None}
    assert {t for _, t in fake_urlopen} == {10.0}


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("workers", [1, 4])
def test_download_dataset_equals_jax(tmp_path, fake_urlopen, workers):
    ids = IDS * 3
    outs = [str(tmp_path / f"{m.__name__}.csv") for m in BOTH]
    counts = [m.download_dataset(ids, out, workers=workers) for m, out in zip(BOTH, outs)]
    (jh, *jrows), (th, *trows) = (_read_csv(o) for o in outs)
    assert counts[1] == counts[0] == len(jrows) == len(trows) == 9
    assert th == jh == ["ZINC_ID", "SMILES"]
    # both write in completion order: with one worker that is input order
    assert sorted(trows) == sorted(jrows)
    if workers == 1:
        assert trows == jrows
    assert sorted(u for u, _ in fake_urlopen) == sorted(
        [jzinc.zinc_substance_url(z) for z in ids] * 2)


def test_download_dataset_defaults_equal_jax(tmp_path, fake_urlopen, monkeypatch):
    """Default workers 2 × os.cpu_count(), default file name and format."""
    seen = []
    for m in BOTH:
        real = m.ThreadPoolExecutor

        def recording(max_workers=None, _real=real, _m=m):
            seen.append((_m.__name__, max_workers))
            return _real(max_workers=max_workers)

        monkeypatch.setattr(m, "ThreadPoolExecutor", recording)
    monkeypatch.setattr(os, "cpu_count", lambda: 3)
    monkeypatch.chdir(tmp_path)
    rows = []
    for m in BOTH:
        n = m.download_dataset(["1", "2", "3"])
        rows.append((n, sorted(_read_csv("zinc_dataset.csv"))))
        os.remove("zinc_dataset.csv")
    assert rows[0] == rows[1] == (2, sorted([["ZINC_ID", "SMILES"],
                                             ["ZINC000000000001", "CCO"],
                                             ["zinc000000000002", "c1ccccc1"]]))
    assert seen == [(jzinc.__name__, 6), (tzinc.__name__, 6)]
    assert {u.rsplit(".", 1)[1] for u, _ in fake_urlopen} == {"smi"}


def test_download_dataset_empty_and_all_failing(tmp_path, fake_urlopen):
    for ids in ([], ["5", "6", "11", "99"]):
        outs = [str(tmp_path / f"{m.__name__}.csv") for m in BOTH]
        counts = [m.download_dataset(ids, o, workers=4) for m, o in zip(BOTH, outs)]
        assert counts == [0, 0]
        assert _read_csv(outs[0]) == _read_csv(outs[1]) == [["ZINC_ID", "SMILES"]]


def test_the_fake_is_all_that_was_called(tmp_path, fake_urlopen, no_network):
    """Every fetch of a bulk run went through the fake, one call an ID, and
    nothing tried to connect or resolve a name."""
    ids = [str(i) for i in range(1, 12)]
    tzinc.download_dataset(ids, str(tmp_path / "t.csv"), workers=4)
    jzinc.download_dataset(ids, str(tmp_path / "j.csv"), workers=4)
    want = sorted(tzinc.zinc_substance_url(z) for z in ids)
    assert sorted(u for u, _ in fake_urlopen) == sorted(want * 2)
    assert no_network == []
