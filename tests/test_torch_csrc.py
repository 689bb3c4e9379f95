"""Static checks of the CUDA sources against their ctypes bindings.

Needs no nvcc and no card. A C function whose parameters differ from what
``_build._SIGNATURES`` gives ctypes (a pointer passed where an int is
declared, a parameter added on one side) fails only on the card, as a
wrong value or a fault; the kernels' determinism forbids float atomics;
and the build digest must see every source file.
"""

import ctypes
import re

import pytest

from gmvae_tpu_torch.ops.kernels import _build

CTYPE_KIND = {ctypes.c_void_p: 'pointer', ctypes.c_int: 'int',
              ctypes.c_uint: 'unsigned', ctypes.c_float: 'float',
              ctypes.c_size_t: 'size_t', ctypes.c_char_p: 'string'}


def _sources():
    return {p.name: p.read_text() for p in sorted(_build.CSRC.iterdir())}


def _c_kind(decl: str) -> str:
    """The ctypes kind of a C declaration: a parameter or a return type."""
    decl = decl.strip()
    if decl.startswith('const char*') or decl == 'const char *':
        return 'string'
    if '*' in decl:
        return 'pointer'
    words = decl.replace('const', ' ').split()
    if 'unsigned' in words:
        return 'unsigned'
    for kind in ('size_t', 'float', 'int'):
        if kind in words:
            return kind
    raise ValueError(f'unknown C type in {decl!r}')


def _param_kind(param: str) -> str:
    """The ctypes kind of a named C parameter."""
    return _c_kind(re.sub(r'\w+$', '', param.strip()))


def _extern_c_functions():
    """{name: (return kind, [parameter kinds])} of every function defined
    in an ``extern "C"`` block of the sources."""
    found = {}
    for name, text in _sources().items():
        if not name.endswith('.cu'):
            continue
        for block in re.findall(r'extern "C" \{(.*?)\n\}  // extern "C"',
                                text, re.S):
            for ret, fn, params in re.findall(
                    r'^((?:const )?\w+\*?)\s+(gmvae_\w+)\(([^)]*)\)\s*\{',
                    block, re.M):
                kinds = [_param_kind(p) for p in params.split(',')
                         if p.strip()]
                found[fn] = (_c_kind(ret), kinds)
    return found


def test_extern_c_functions_match_their_ctypes_signatures():
    funcs = _extern_c_functions()
    assert set(funcs) == set(_build._SIGNATURES), (
        sorted(set(funcs) ^ set(_build._SIGNATURES)))
    for name, (restype, argtypes) in _build._SIGNATURES.items():
        ret, params = funcs[name]
        assert CTYPE_KIND[restype] == ret, name
        assert [CTYPE_KIND[a] for a in argtypes] == params, name


@pytest.mark.parametrize('param, kind', [
    ('const float* k_logits', 'pointer'), ('unsigned int k0', 'unsigned'),
    ('float tau', 'float'), ('int B', 'int'), ('void* stream', 'pointer'),
    ('unsigned int* ticket', 'pointer'), ('const void* c0', 'pointer')])
def test_param_kind_reads_each_declaration(param, kind):
    assert _param_kind(param) == kind


def test_no_float_atomics_in_the_kernels():
    """Run-to-run bit-determinism: every atomicAdd adds an integer literal
    into an integer buffer, and no PTX reduction adds floats."""
    for name, text in _sources().items():
        code = re.sub(r'//[^\n]*', '', text)
        for target, value in re.findall(
                r'atomicAdd(?:_block|_system)?\s*\(\s*([^,]+),\s*([^)]+)\)',
                code):
            # the pointer (or member) before any offset: `out.ticket + r`
            var = re.findall(r'\w+', re.split(r'[+-]', target)[0])[-1]
            decls = re.findall(r'([\w ]+)\*\s*' + var + r'\s*[;,)]', code)
            assert decls, (name, target)
            assert all(re.search(r'\b(unsigned|int)\b', d)
                       and not re.search(r'\b(float|double)\b', d)
                       for d in decls), (name, target, decls)
            assert re.fullmatch(r'\s*\d+u?\s*', value), (name, value)
        assert not re.search(r'\.add\.f(16|32|64)|red\.[\w.:]*\.f(32|64)',
                             code), name


def test_every_source_is_built_and_hashed():
    listed = set(_build.SOURCES) | set(_build.HEADERS)
    assert set(_sources()) == listed
    assert all(name.endswith('.cu') for name in _build.SOURCES)
