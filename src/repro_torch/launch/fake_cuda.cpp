// A CUDA device for fake tensors on a torch build without CUDA, so that
// the dry-run (launch/dryrun.py) traces the card's path there, backward
// included.  Loaded with LD_PRELOAD (dryrun.fake_cuda_env), before torch
// asks which accelerator it has.
//
// Such a build registers no device guard for CUDA, and a few of torch's
// entry points want one even when every tensor is fake: the Python
// bindings of some Tensor methods (``contiguous``, indexing) and
// autograd's record of a CUDA tensor.  c10's FakeGuardImpl (the guard
// c10's own tests use) answers them without a device.  Autograd's
// backward also asks for the accelerator's current stream: CUDA hooks
// that say CUDA is built, with no primary context, make it take the
// guard's stream and sync nothing.  torch.cuda.is_available() stays
// false.  A CUDA build has its own guard and hooks; this library is
// never loaded there.  Built by dryrun.fake_cuda_library with the host
// compiler against torch's headers.
#include <ATen/detail/CUDAHooksInterface.h>
#include <c10/core/impl/FakeGuardImpl.h>

namespace {

c10::impl::FakeGuardImpl<c10::DeviceType::CUDA> guard;

struct FakeCUDAHooks : at::CUDAHooksInterface {
  explicit FakeCUDAHooks(at::CUDAHooksArgs) {}
  bool isBuilt() const override { return true; }
  bool hasPrimaryContext(c10::DeviceIndex) const override { return false; }
};

__attribute__((constructor)) void set_cuda_guard() {
  auto& slot = c10::impl::device_guard_impl_registry[static_cast<size_t>(
      c10::DeviceType::CUDA)];
  if (slot.load() == nullptr) slot.store(&guard);
}

}  // namespace

namespace at {
C10_REGISTER_CLASS(CUDAHooksRegistry, CUDAHooks, FakeCUDAHooks)
}  // namespace at
