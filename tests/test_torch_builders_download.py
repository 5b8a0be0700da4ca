"""The port's config/builders.py and data/download.py against the JAX
package's copies: the twins of tests/test_infra_units.py's builder tests
and of tests/test_download.py.  Both sides run on the same inputs and must
give the same result; the downloader calls a stub ``datalad`` put on
``PATH`` (nothing is fetched)."""

import os
import stat
from pathlib import Path

import pydantic
import pytest

from algonauts2025_tpu.config import builders as jax_builders
from algonauts2025_tpu.data.download import Datalad as JaxDatalad
from algonauts2025_tpu_torch.config.builders import all_subclasses, convert_to_pydantic, validate_kwargs
from algonauts2025_tpu_torch.data.download import Datalad

_STUB = """#!/bin/sh
echo "$@" >> "$DATALAD_STUB_LOG"
if [ "$1" = "clone" ]; then mkdir -p "$3"; fi
exit 0
"""


class Thing:
    def __init__(self, alpha: int, beta: float = 2.0):
        self.alpha = alpha
        self.beta = beta


class Base(pydantic.BaseModel):
    model_config = pydantic.ConfigDict(extra="forbid")
    name: str


@pytest.mark.parametrize("convert", [convert_to_pydantic, jax_builders.convert_to_pydantic],
                         ids=["port", "jax"])
def test_convert_to_pydantic_builds_and_forbids(convert):
    Cfg = convert(Thing, "Thing", parent_class=Base)
    built = Cfg(alpha=3).build()
    assert isinstance(built, Thing)
    assert (built.alpha, built.beta) == (3, 2.0)
    assert Cfg(alpha=1).name == "Thing"
    assert Cfg(alpha=1).model_dump() == {"name": "Thing", "alpha": 1, "beta": 2.0}
    with pytest.raises(pydantic.ValidationError):
        Cfg(alpha=1, gamma=5)  # extra="forbid" inherited
    with pytest.raises(pydantic.ValidationError):
        Cfg()  # alpha is required


def test_converted_fields_match_jax():
    port = convert_to_pydantic(Thing, "Thing", parent_class=Base, exclude_from_build=["beta"])
    ref = jax_builders.convert_to_pydantic(Thing, "Thing", parent_class=Base,
                                           exclude_from_build=["beta"])
    assert port.model_json_schema() == ref.model_json_schema()
    assert port(alpha=4, beta=9.0).build().beta == ref(alpha=4, beta=9.0).build().beta == 2.0

    class Child(Base):
        pass

    class GrandChild(Child):
        pass

    assert all_subclasses(Base) == jax_builders.all_subclasses(Base) >= {Child, GrandChild}


@pytest.mark.parametrize("validate", [validate_kwargs, jax_builders.validate_kwargs],
                         ids=["port", "jax"])
def test_validate_kwargs(validate):
    def fn(a, b=1):
        return a + b

    validate(fn, {"a": 1, "b": 2})
    with pytest.raises(ValueError, match="Invalid kwarg 'c'"):
        validate(fn, {"c": 3})

    def fn_var(a, **kw):
        return a

    validate(fn_var, {"anything": 1})  # **kwargs accepts all


@pytest.fixture()
def stub_datalad(tmp_path, monkeypatch):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    stub = bindir / "datalad"
    stub.write_text(_STUB)
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    log = tmp_path / "calls.log"
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("DATALAD_STUB_LOG", str(log))
    return log


def _calls(log: Path) -> list[str]:
    return log.read_text().splitlines() if log.exists() else []


def _run_both(tmp_path, stub_log, **kw):
    """The port's and the JAX downloader over two dataset dirs: their
    command lines (without the dirs) and their markers."""
    out = []
    for name, cls in (("port", Datalad), ("jax", JaxDatalad)):
        start = len(_calls(stub_log))
        dl = cls(dset_dir=tmp_path / name, **kw)
        dl.download()
        calls = [c.replace(str(tmp_path / name), "<ds>") for c in _calls(stub_log)[start:]]
        markers = sorted(p.name for p in (tmp_path / name).glob(".download_*"))
        out.append((calls, markers))
    return out


def test_download_clone_and_get(tmp_path, stub_datalad):
    dl = Datalad(dset_dir=tmp_path / "ds", paths=["fmri", "stimuli/movies"], jobs=2)
    out = dl.download()
    assert out == tmp_path / "ds" / "download" / "algonauts_2025.competitors"
    calls = _calls(stub_datalad)
    assert calls[0].startswith("clone ")
    assert "get -J 2 fmri" in calls[1]
    assert "get -J 2 stimuli/movies" in calls[2]
    markers = sorted(p.name for p in (tmp_path / "ds").glob(".download_*"))
    assert markers == [
        ".download_clone_success.txt",
        ".download_get_fmri_success.txt",
        ".download_get_stimuli_movies_success.txt",
    ]
    port, ref = _run_both(tmp_path, stub_datalad, paths=["fmri", "stimuli/movies"], jobs=2)
    assert port == ref


def test_download_resumes_from_markers(tmp_path, stub_datalad):
    dl = Datalad(dset_dir=tmp_path / "ds", paths=["fmri"])
    dl.download()
    n_first = len(_calls(stub_datalad))
    dl.download()  # second call: everything marker-gated, no new commands
    assert len(_calls(stub_datalad)) == n_first

    # a new target triggers only its own fetch
    Datalad(dset_dir=tmp_path / "ds", paths=["fmri", "stimuli"]).download()
    calls = _calls(stub_datalad)
    assert len(calls) == n_first + 1
    assert calls[-1].endswith("stimuli")

    # the JAX downloader resumes from the port's markers alike
    start = len(calls)
    JaxDatalad(dset_dir=tmp_path / "ds", paths=["fmri", "stimuli"]).download()
    assert len(_calls(stub_datalad)) == start


@pytest.mark.parametrize("cls", [Datalad, JaxDatalad], ids=["port", "jax"])
def test_download_requires_datalad(tmp_path, monkeypatch, cls):
    monkeypatch.setenv("PATH", str(tmp_path))  # no datalad anywhere
    with pytest.raises(RuntimeError, match="datalad is not installed"):
        cls(dset_dir=tmp_path / "ds").download()
