"""Settings of every test under ``benchmark/``: the program streams a
rehearsal's files (a few hundred reads each) in windows of 64 reads, as it
streams a cell's files on the card in windows of 16,384, so that a
rehearsed run has the runner's per-window spans to read."""

import pytest


@pytest.fixture(autouse=True)
def streaming_windows(monkeypatch):
    monkeypatch.setenv("TAGDUST_TPU_BT", "8")
    monkeypatch.setenv("TAGDUST_TPU_WINDOW", "64")
