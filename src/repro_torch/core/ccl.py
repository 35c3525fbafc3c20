"""Parser for the paper's ``cacuda.ccl`` declarative kernel syntax.

The port of ``repro.core.ccl``: it builds the port's
:class:`~repro_torch.core.descriptor.StencilDescriptor`, field for field the
reference's.

The paper's code generator is built on Piraha, a parsing-expression-grammar
engine; the grammar needed for ``cacuda.ccl`` is small enough that a
recursive-descent parser is clearer and dependency-free.  The accepted syntax
is exactly Listing 1 of the paper::

    CCTK_CUDA_KERNEL UPDATE_VELOCITY
      TYPE=3DBLOCK
      STENCIL="1,1,1,1,1,1"
      TILE="16,16,16"
    {
      CCTK_CUDA_KERNEL_VARIABLE CACHED=YES INTENT=SEPARATEINOUT
      {
        vx, vy, vz
      } "VELOCITY"
      CCTK_CUDA_KERNEL_PARAMETER
      {
        density
      } "DENSITY"
    }

Multiple kernels per file are allowed; ``#`` starts a comment.
"""
from __future__ import annotations

import re

from repro_torch.core.descriptor import Intent, StencilDescriptor, VariableGroup

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+|\#[^\n]*)
  | (?P<string>"[^"]*")
  | (?P<punct>[{}=,])
  | (?P<word>[A-Za-z0-9_]+)
    """,
    re.VERBOSE,
)


class CCLSyntaxError(ValueError):
    pass


def _tokenize(text: str) -> list[str]:
    toks: list[str] = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise CCLSyntaxError(f"unexpected character {text[pos]!r} at offset {pos}")
        pos = m.end()
        if m.lastgroup != "ws":
            toks.append(m.group())
    return toks


class _Cursor:
    def __init__(self, toks: list[str]):
        self.toks = toks
        self.i = 0

    def peek(self) -> str | None:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self) -> str:
        tok = self.peek()
        if tok is None:
            raise CCLSyntaxError("unexpected end of input")
        self.i += 1
        return tok

    def expect(self, tok: str) -> None:
        got = self.next()
        if got != tok:
            raise CCLSyntaxError(f"expected {tok!r}, got {got!r}")


def _int_list(s: str) -> tuple[int, ...]:
    return tuple(int(x) for x in s.strip('"').split(","))


def _parse_attrs(cur: _Cursor) -> dict[str, str]:
    """KEY=VALUE pairs until a '{'."""
    attrs: dict[str, str] = {}
    while cur.peek() != "{":
        key = cur.next()
        cur.expect("=")
        attrs[key.upper()] = cur.next()
    return attrs


def _parse_name_list(cur: _Cursor) -> tuple[str, ...]:
    cur.expect("{")
    names: list[str] = []
    while cur.peek() != "}":
        tok = cur.next()
        if tok == ",":
            continue
        names.append(tok)
    cur.expect("}")
    return tuple(names)


def _parse_kernel(cur: _Cursor) -> StencilDescriptor:
    name = cur.next()
    attrs = _parse_attrs(cur)
    cur.expect("{")
    variables: list[VariableGroup] = []
    parameters: list[str] = []
    while cur.peek() != "}":
        tok = cur.next()
        if tok == "CCTK_CUDA_KERNEL_VARIABLE":
            vattrs = _parse_attrs(cur)
            names = _parse_name_list(cur)
            group = ""
            if cur.peek() and cur.peek().startswith('"'):
                group = cur.next().strip('"')
            variables.append(
                VariableGroup(
                    names=names,
                    intent=Intent(vattrs.get("INTENT", "IN").upper()),
                    cached=vattrs.get("CACHED", "YES").upper() == "YES",
                    group=group,
                )
            )
        elif tok == "CCTK_CUDA_KERNEL_PARAMETER":
            # parameters take no attributes in the paper's listing
            names = _parse_name_list(cur)
            parameters.extend(names)
            if cur.peek() and cur.peek().startswith('"'):
                cur.next()  # group label, unused for parameters
        else:
            raise CCLSyntaxError(f"unexpected token {tok!r} inside kernel body")
    cur.expect("}")

    return StencilDescriptor(
        name=name,
        variables=tuple(variables),
        stencil=_int_list(attrs.get("STENCIL", '"1,1,1,1,1,1"')),
        tile=_int_list(attrs.get("TILE", '"8,8,128"')),
        type=attrs.get("TYPE", "3DBLOCK").strip('"'),
        parameters=tuple(parameters),
    )


def parse_ccl(text: str) -> list[StencilDescriptor]:
    """Parse a cacuda.ccl document into kernel descriptors."""
    cur = _Cursor(_tokenize(text))
    kernels: list[StencilDescriptor] = []
    while cur.peek() is not None:
        cur.expect("CCTK_CUDA_KERNEL")
        kernels.append(_parse_kernel(cur))
    return kernels


def parse_ccl_file(path: str) -> list[StencilDescriptor]:
    with open(path) as f:
        return parse_ccl(f.read())
