"""The marker of the tests that need a card, and the fixture that decides
inside a test (never at import) whether there is one."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped on a machine without")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark's cells run only on one")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _few_threads():
    """Few intra-op threads: the suite runs beside other workers."""
    import torch
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)
