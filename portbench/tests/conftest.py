"""The benchmark's own tests (run them with `python -m pytest portbench/tests`;
the repository's suite under tests/ does not collect them).  Tests marked
`cuda` need the card and skip without one; they decide so in a fixture."""
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
