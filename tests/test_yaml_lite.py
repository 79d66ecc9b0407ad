"""The in-repo YAML reader (scene/yaml_lite.py) against PyYAML on the
scene files and scene snippets the repo carries."""

import pathlib

import pytest

from raytracer_tpu.scene.yaml_lite import YamlError, safe_load

yaml = pytest.importorskip("yaml")

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _inline(module, name):
    import importlib
    import sys

    sys.path.insert(0, str(ROOT / "tests"))
    return getattr(importlib.import_module(module), name)


SNIPPETS = {
    "comments_and_quotes": """
# leading comment
- add: camera   # trailing comment
  width: 8
  label: "a # not a comment"
  other: 'it''s'
  fov: PI/3
""",
    "same_indent_sequence": """
- add: group
  transform:
  - [scale, 0.5, 0.5, 0.5]
  - [rotate-y, -1.5707963]
  shapes:
  - add: sphere
    shadow: false
""",
    "scalars": """
- ints: [0, -3, +7, 1_000]
  floats: [1.5, -0.15, .5, 1e-5, 2.0e+3, .inf, -.inf]
  bools: [true, False, yes, off]
  nulls: [~, null]
  empty:
  nested: [[1, 2], [], {kind: image, ppm: a.ppm}]
""",
    "nested_items": """
- - 1
  - 2
- kind: csg
  args:
    - kind: sphere
    -
      kind: cube
""",
}


@pytest.mark.parametrize("name", sorted(SNIPPETS))
def test_matches_pyyaml_on_snippets(name):
    text = SNIPPETS[name]
    assert safe_load(text) == yaml.safe_load(text)


@pytest.mark.parametrize("source", [
    "dragons_equiv", "cli", "earth", "skybox",
])
def test_matches_pyyaml_on_scenes(source):
    text = {
        "dragons_equiv": lambda: (
            ROOT / "benchmarks/dragons_equiv.yaml").read_text(),
        "cli": lambda: _inline("test_cli", "SCENE"),
        "earth": lambda: _inline("test_texture_scenes", "EARTH_SCENE"),
        "skybox": lambda: _inline("test_texture_scenes", "SKYBOX_SCENE"),
    }[source]()
    got = safe_load(text)
    assert got == yaml.safe_load(text)
    assert isinstance(got, list) and got


@pytest.mark.parametrize("text", [
    "- a: &anchor 1\n",
    "- a: [1, 2\n",
    "- a: |\n    block\n",
])
def test_rejects_syntax_outside_the_subset(text):
    with pytest.raises(YamlError):
        safe_load(text)
