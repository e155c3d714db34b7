"""The I3D's 3D max pool off the card: `models/layers.max_pool_3d_same`'s
routing (a CPU input to the plain version; a CUDA input to B6's custom
op unless autograd will need its gradient, which keeps PyTorch's pad and
pool), checked by the ops a call dispatches, with CPU tensors routed as
CUDA tensors where the card's route is tested; B6's fake
implementation's shapes on every pool call of an I3D forward at 256 and
768 frames and on odd extents, against the plain version on the meta
device; the plain version against a NumPy max over each zero-padded
window, NaN, +-inf and -0.0 planted; and B6's wrapper refusing, before
any launch, what the kernel does not take."""

import itertools

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from torch_suite import suite_policy  # noqa: F401 (autouse)

from opental_torch.models import i3d, layers
from opental_torch.ops import _build, max_pool3d_cuda

B6_OP = 'opental::max_pool3d_same'
LIBRARY = ('aten::constant_pad_nd', 'aten::max_pool3d_with_indices')
# (x shape, kernel, stride) at odd extents: one frame, 3 x 3 and 1 x 1
# planes, sides that no vector width divides
ODD = [(shape,) + spec for shape in ((1, 5, 1, 3, 3), (2, 3, 3, 5, 7),
                                    (1, 7, 2, 1, 1), (3, 11, 9, 13, 11))
       for spec in max_pool3d_cuda.SPECS]


class Dispatched(TorchDispatchMode):
    """The names of the ops dispatched while it is entered."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(func.name())
        return func(*args, **(kwargs or {}))


@pytest.fixture
def as_card(monkeypatch):
    """CPU tensors routed as CUDA tensors: `is_cuda` reads True, and B6's
    op has a CPU implementation, the plain version."""
    lib = torch.library.Library('opental', 'IMPL')
    lib.impl('max_pool3d_same', layers.max_pool_3d_same_plain, 'CPU')
    monkeypatch.setattr(torch.Tensor, 'is_cuda', property(lambda t: True))
    yield
    monkeypatch.undo()
    lib._destroy()


@pytest.mark.parametrize('card,requires_grad,grad,want', [
    (False, False, False, LIBRARY),
    (False, True, True, LIBRARY),
    (True, False, True, (B6_OP,)),
    (True, True, False, (B6_OP,)),
    (True, True, True, LIBRARY),
])
def test_route(request, card, requires_grad, grad, want):
    """The ops that one (3, 3, 3) / (1, 1, 1) pool dispatches: B6's op
    alone, or PyTorch's pad and pool."""
    if card:
        request.getfixturevalue('as_card')
    x = torch.from_numpy(np.random.RandomState(0).randn(
        1, 4, 6, 5, 5).astype(np.float32)).requires_grad_(requires_grad)
    with torch.set_grad_enabled(grad), Dispatched() as seen:
        y = layers.max_pool_3d_same(x, (3, 3, 3), (1, 1, 1))
    assert tuple(seen.names) == want
    assert y.requires_grad == (requires_grad and grad)
    assert torch.equal(y, layers.max_pool_3d_same_plain(x, (3, 3, 3),
                                                        (1, 1, 1)))


def assert_fake_shapes(calls):
    with FakeTensorMode():
        for shape, kernel, stride in calls:
            x = torch.empty(shape, device='cuda', dtype=torch.bfloat16)
            got = max_pool3d_cuda.max_pool3d_same_op(x, list(kernel),
                                                     list(stride))
            assert got.device.type == 'cuda' and got.dtype == x.dtype
            want = layers.max_pool_3d_same_plain(
                torch.empty(shape, device='meta'), kernel, stride)
            assert tuple(got.shape) == tuple(want.shape), (shape, kernel)


@pytest.mark.parametrize('case', ['256 frames', '768 frames', 'odd'])
def test_fake_shapes(case):
    if case == 'odd':
        calls = ODD
    else:
        calls = i3d.pool_calls(1, int(case.split()[0]), 96)
        assert len(calls) == 13
        assert {(k, s) for _, k, s in calls} == set(max_pool3d_cuda.SPECS)
    assert_fake_shapes(calls)


def numpy_pool(x: np.ndarray, kernel, stride) -> np.ndarray:
    """The max over each TF-SAME zero-padded window, taken one window at
    a time (NaN where the window holds one)."""
    pads = []
    for size, k, s in zip(x.shape[2:], kernel, stride):
        total = max(k - (s if size % s == 0 else size % s), 0)
        pads.append((total // 2, total - total // 2))
    xp = np.pad(x, [(0, 0), (0, 0)] + pads)
    outs = [(size + a + b - k) // s + 1
            for size, (a, b), k, s in zip(x.shape[2:], pads, kernel, stride)]
    y = np.empty(x.shape[:2] + tuple(outs), x.dtype)
    for t, h, w in itertools.product(*map(range, outs)):
        win = xp[:, :, t * stride[0]:t * stride[0] + kernel[0],
                 h * stride[1]:h * stride[1] + kernel[1],
                 w * stride[2]:w * stride[2] + kernel[2]]
        y[:, :, t, h, w] = win.reshape(win.shape[:2] + (-1,)).max(-1)
    return y


@pytest.mark.parametrize('kernel,stride', max_pool3d_cuda.SPECS)
@pytest.mark.parametrize('shape', [(2, 3, 7, 9, 10), (1, 2, 1, 3, 3),
                                   (1, 3, 4, 1, 2)])
def test_plain_is_the_max_of_each_padded_window(shape, kernel, stride):
    rng = np.random.RandomState(sum(shape))
    x = rng.randn(*shape).astype(np.float32)
    x[:, 1::2] -= 4                            # the zero pad wins there
    flat = x.reshape(-1)
    for value, n in ((np.nan, 1), (np.inf, 1), (-np.inf, 1), (-0.0, 5)):
        flat[rng.randint(0, flat.size, n)] = value
    got = layers.max_pool_3d_same_plain(torch.from_numpy(x), kernel, stride)
    want = numpy_pool(x, kernel, stride)
    np.testing.assert_array_equal(got.numpy(), want)
    # the routed CPU call is the plain version
    np.testing.assert_array_equal(
        layers.max_pool_3d_same(torch.from_numpy(x), kernel, stride).numpy(),
        want)
    pads = layers._f_pad(shape[2:], kernel, stride)
    np.testing.assert_array_equal(
        F.max_pool3d(F.pad(torch.from_numpy(x), pads), kernel,
                     stride).numpy(), want)


@pytest.mark.parametrize('case,error', [
    ('cpu tensor', 'CUDA tensor'), ('spec', 'specs'), ('dtype', 'float32'),
    ('layout', 'contiguous'), ('empty extent', 'empty')])
def test_the_wrapper_refuses_what_b6_does_not_take(request, case, error):
    """Each refusal raises before any launch (the card's checks run on CPU
    tensors routed as CUDA tensors, except the first)."""
    if case != 'cpu tensor':
        request.getfixturevalue('as_card')
    x = torch.zeros(1, 2, 4, 6, 6)
    kernel, stride = (3, 3, 3), (1, 1, 1)
    if case == 'spec':
        stride = (1, 2, 2)
    elif case == 'dtype':
        x = x.half()
    elif case == 'layout':
        x = x.to(memory_format=torch.channels_last_3d)
    elif case == 'empty extent':
        x = torch.zeros(1, 2, 0, 6, 6)
    with pytest.raises((ValueError, TypeError), match=error):
        max_pool3d_cuda.max_pool3d_same(x, kernel, stride)
    assert max_pool3d_cuda.NAME not in _build._LOADED
