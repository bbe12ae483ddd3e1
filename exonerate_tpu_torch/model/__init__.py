from .ir import (
    Scope, Label, Protect, Calc, State, Transition, Shadow, Portal, Span,
    Model, DerivedModel,
)
