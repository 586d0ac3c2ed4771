"""pytest settings of the benchmark's own tests (``python -m pytest
p3dbench -q``): the ``chip`` marker of tests that need the card, which
skip without one."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs an NVIDIA card; skips on the CPU")
