"""pytest settings of the repository root: registers the marker of tests
that need an NVIDIA card (they skip without one; run them on the card
with `python -m pytest tests/ -m cuda`)."""


def pytest_configure(config):
  config.addinivalue_line(
      "markers", "cuda: needs an NVIDIA card and nvcc; skipped without them")
