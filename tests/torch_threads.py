"""One intra-op thread for a PyTorch test module or test, the previous
count back after it: where pytest-xdist workers share the cores,
PyTorch's pool spins at the barrier of each small CPU op
(test_torch_sharding.py's note).

A test module registers it as a fixture at the scope it wants:

    one_intra_op_thread = pytest.fixture(autouse=True, scope="module")(
        torch_threads.one_intra_op_thread)
"""
import torch


def one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
