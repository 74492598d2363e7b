"""Route programming (the port's copy of `openr_tpu/fib/`): `Fib`
consumes the Decision's RouteUpdates and programs them through a
`FibService`-shaped handler, in tests and the smoke run
`MockFibHandler`."""

from openr_tpu_torch.fib.fib import (  # noqa: F401
    CLIENT_ID_OPENR,
    CLIENT_ID_STATIC,
    Fib,
    FibProgramError,
    FibService,
    MockFibHandler,
)
