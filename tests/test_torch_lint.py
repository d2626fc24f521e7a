"""The port's hazard linter (``repro_torch.analysis.lint``): each fixture
of ``tests/torch_lint_fixtures/`` flags exactly its hazard, the near-miss
file is clean, waivers are rule-specific, the catalog is pinned, the
default paths lint clean, and on the JAX package's own fixtures (read,
never edited) the port's cache and import rules flag the lines the JAX
linter flags."""
from pathlib import Path

import pytest

from repro.analysis import lint as jlint
from repro_torch.analysis import lint

REPO = Path(__file__).resolve().parents[1]
FIX = REPO / "tests" / "torch_lint_fixtures"
JFIX = REPO / "tests" / "lint_fixtures"


def _active(findings):
    return [(f.line, f.rule) for f in findings if not f.waived]


def test_the_rule_catalog_is_pinned():
    assert lint.RULES == ("cuda-unsynced-timing", "cached-tensor-args",
                          "repro-torch-imports-benchmarks")
    assert not set(lint.RULES) & set(jlint.RULES)


@pytest.mark.parametrize("name, is_library, want", [
    ("bad_unsynced_timing.py", False, [(12, "cuda-unsynced-timing")]),
    ("bad_cached_tensors.py", False, [(10, "cached-tensor-args"),
                                      (15, "cached-tensor-args")]),
    ("bad_library_import.py", True,
     [(4, "repro-torch-imports-benchmarks")]),
])
def test_each_fixture_flags_exactly_its_hazard(name, is_library, want):
    assert _active(lint.lint_file(FIX / name, is_library)) == want


def test_the_near_miss_file_is_clean():
    found = lint.lint_file(FIX / "clean_near_misses.py", True)
    assert _active(found) == []
    assert [(f.rule, f.waived) for f in found] == \
        [("cuda-unsynced-timing", True)]


def test_waivers_are_rule_specific():
    src = (FIX / "bad_unsynced_timing.py").read_text()
    jax_waived = src.replace("# <-- finding: times launches",
                             "# lint: waive=unsynced-timing")
    assert _active(lint.lint_source(jax_waived)) == \
        [(12, "cuda-unsynced-timing")]
    other = src.replace("# <-- finding: times launches",
                        "# lint: waive=cached-tensor-args")
    assert _active(lint.lint_source(other)) == [(12, "cuda-unsynced-timing")]
    ours = src.replace("# <-- finding: times launches",
                       "# lint: waive=unsynced-timing,cuda-unsynced-timing")
    assert _active(lint.lint_source(ours)) == []
    assert _active(jlint.lint_source(ours)) == []


@pytest.mark.parametrize("name, rule, jrule", [
    ("bad_cached_arrays.py", "cached-tensor-args", "cached-array-args"),
    ("bad_library_import.py", "repro-torch-imports-benchmarks",
     "repro-imports-benchmarks"),
])
def test_the_jax_fixtures_flag_the_same_lines(name, rule, jrule):
    src = (JFIX / name).read_text()
    ours = [f.line for f in lint.lint_source(src, name, is_library=True)
            if f.rule == rule and not f.waived]
    theirs = [f.line for f in jlint.lint_source(src, name, is_repro=True)
              if f.rule == jrule and not f.waived]
    assert ours == theirs and ours


def test_the_default_paths_lint_clean(monkeypatch, capsys):
    """``python -m repro_torch.analysis.lint``'s ``main`` from the repo's
    root, with its default paths."""
    monkeypatch.chdir(REPO)
    assert lint.main([]) == 0, capsys.readouterr().out
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1].startswith("lint: 0 finding(s)")
    walked = {str(p) for p in lint._expand(lint.DEFAULT_PATHS)}
    assert {"src/repro_torch", "chip_smoke.py",
            "examples/serve_lm_torch.py"} <= walked
