"""``gui`` in the port: its copy of the annotator is byte-equal to the JAX
package's, and the command opens that copy (``webbrowser`` mocked), or the
file ``TOPAZ_GUI_PATH`` names, and exits 1 where the file is missing."""

import importlib
import os
import webbrowser

import pytest

from topaz_tpu_torch.cli.main import main as tmain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_HTML = os.path.join(REPO, "topaz_tpu_torch", "gui", "topaz_tpu_gui.html")


def test_html_copy_is_byte_equal():
    with open(PORT_HTML, "rb") as f, open(os.path.join(
            REPO, "topaz_tpu", "gui", "topaz_tpu_gui.html"), "rb") as g:
        port, jax = f.read(), g.read()
    assert port == jax and len(port) == 34876


def _opened(monkeypatch, env):
    from topaz_tpu_torch.cli.commands import gui

    if env is None:
        monkeypatch.delenv("TOPAZ_GUI_PATH", raising=False)
    else:
        monkeypatch.setenv("TOPAZ_GUI_PATH", env)
    importlib.reload(gui)
    calls = []
    monkeypatch.setattr(webbrowser, "open", lambda url, new=0: calls.append((url, new)))
    try:
        tmain(["gui"])
    finally:
        monkeypatch.delenv("TOPAZ_GUI_PATH", raising=False)
        importlib.reload(gui)
    return calls


def test_gui_opens_the_ports_copy(monkeypatch):
    assert _opened(monkeypatch, None) == [("file://" + os.path.realpath(PORT_HTML), 2)]


def test_gui_path_override(monkeypatch, tmp_path):
    other = tmp_path / "topaz.html"
    other.write_text("<html></html>")
    assert _opened(monkeypatch, str(other)) == [("file://" + os.path.realpath(other), 2)]
    with pytest.raises(SystemExit) as e:
        _opened(monkeypatch, str(tmp_path / "missing.html"))
    assert e.value.code == 1
