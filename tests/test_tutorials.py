"""Execute the tutorial notebooks end-to-end (they synthesise their own
data) — the notebooks are the reference's de-facto integration tests
(SURVEY.md §4), so ours must actually run."""

import os
import shutil

import nbformat
import pytest
from nbclient import NotebookClient

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(nb_path, tmp_path, monkeypatch):
    # the kernel runs with cwd=tmp_path: put the repo on its import path
    # (monkeypatch restores the env var after the test, so repeated runs
    # don't keep prepending and the state doesn't leak into other tests)
    monkeypatch.setenv(
        "PYTHONPATH", REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    # the yolo notebook reads tests/fixtures/tiny_test.cfg relative to cwd
    os.makedirs(tmp_path / "tests" / "fixtures", exist_ok=True)
    shutil.copy(os.path.join(REPO, "tests", "fixtures", "tiny_test.cfg"),
                tmp_path / "tests" / "fixtures" / "tiny_test.cfg")
    nb = nbformat.read(nb_path, as_version=4)
    # pin the kernel to CPU like the rest of the suite: the kernel is a
    # subprocess, so conftest's settings do not reach it
    nb.cells.insert(0, nbformat.v4.new_code_cell(
        "import jax\njax.config.update('jax_platforms', 'cpu')"))
    client = NotebookClient(nb, timeout=600, kernel_name="python3",
                            resources={"metadata": {"path": str(tmp_path)}})
    client.execute()


@pytest.mark.slow
def test_yolo_tutorial_executes(tmp_path, monkeypatch):
    _run(os.path.join(REPO, "tutorials", "yolo_tutorial.ipynb"), tmp_path,
         monkeypatch)


@pytest.mark.slow
def test_keypoints_tutorial_executes(tmp_path, monkeypatch):
    _run(os.path.join(REPO, "tutorials", "keypoints_tutorial.ipynb"), tmp_path,
         monkeypatch)
