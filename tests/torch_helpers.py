"""Shared helpers of the PyTorch port's tests (tests/test_torch_*.py).

Inputs and weights are made with numpy from a seed and handed to both
packages: the JAX package on the CPU is the reference, the port runs its
plain PyTorch versions on the CPU.
"""

import pathlib
import re

import numpy as np
import torch

# tier-1 runs several xdist workers on few cores
torch.set_num_threads(2)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def random_variables(module, *args, seed: int = 0, **kwargs):
    """A variable tree of numpy arrays with ``module``'s structure (shapes
    from jax.eval_shape, so nothing compiles) and weights drawn from numpy:
    fan-in scaled kernels, small biases, near-unit norm scales, layer-scales
    in [0.1, 0.5] so every ConvNeXt block moves the output, unit-normal
    rel-pos tables so no window softmax is uniform, BatchNorm running means
    near 0 and variances in [0.5, 1.5], and normal prototypes and classifier
    mats."""
    import jax

    shapes = jax.eval_shape(lambda *a: module.init(jax.random.PRNGKey(0), *a, **kwargs),
                            *args)
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        shape = s.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            v = rng.randn(*shape) / np.sqrt(fan_in)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.randn(*shape)
        elif name == "bias":
            v = 0.1 * rng.randn(*shape)
        elif name == "gamma":
            v = rng.uniform(0.1, 0.5, shape)
        elif name == "mean":
            v = 0.1 * rng.randn(*shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, shape)
        elif name in ("w1", "w2", "w3"):
            v = rng.randn(*shape) / np.sqrt(shape[0])
        else:
            v = rng.randn(*shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def load_port(module, variables, prefix: str = ""):
    """Load a JAX variable tree into a port module through
    ``from_jax_variables``; ``prefix`` selects one subtree's keys."""
    from segland_tpu_torch.ckpt import from_jax_variables

    sd = {k[len(prefix):]: t(v) for k, v in from_jax_variables(variables).items()
          if k.startswith(prefix)}
    module.load_state_dict(sd, strict=True)
    return module


def near_tie_pixels(logits_up: np.ndarray, tol: float = 1e-3) -> np.ndarray:
    """Mask of pixels whose top-2 classes lie within ``tol`` of each other."""
    top2 = np.sort(logits_up, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) <= tol


# ---- reading the CUDA sources ---------------------------------------------------------
# Host tests replay a kernel's schedule from its own source text (the constexpr
# arithmetic of its plan structs, the loops around its calls), so that a change
# to the .cu shows in the replay without a copy of it in Python.
CSRC = pathlib.Path(__file__).resolve().parents[1] / "segland_tpu_torch/kernels/csrc"


def csrc(name: str) -> str:
    """The source file ``name`` without its // comments."""
    return "\n".join(line.split("//")[0] for line in (CSRC / name).read_text().splitlines())


def _parens(e: str, i: int) -> int:
    """The index just past the ) that closes the ( at e[i]."""
    depth = 0
    for j in range(i, len(e)):
        depth += (e[j] == "(") - (e[j] == ")")
        if depth == 0:
            return j + 1
    raise ValueError(f"unbalanced parentheses in {e!r}")


def _ternary(e: str) -> str:
    """C's cond ? a : b as Python's (a if cond else b), nested ones too."""
    depth, q = 0, None
    for i, ch in enumerate(e):
        depth += (ch == "(") - (ch == ")")
        if ch == "?" and depth == 0:
            q = i
            break
    if q is None:  # convert inside each top-level group
        out, i = [], 0
        while (k := e.find("(", i)) >= 0:
            end = _parens(e, k)
            out += [e[i:k + 1], _ternary(e[k + 1:end - 1]), ")"]
            i = end
        return "".join(out) + e[i:]
    depth, nest = 0, 0
    for j in range(q + 1, len(e)):
        depth += (e[j] == "(") - (e[j] == ")")
        if depth == 0 and e[j] == "?":
            nest += 1
        elif depth == 0 and e[j] == ":":
            if nest == 0:
                break
            nest -= 1
    return f"(({_ternary(e[q + 1:j])}) if ({_ternary(e[:q])}) else ({_ternary(e[j + 1:])}))"


def c_eval(expr: str, env) -> int:
    """The value of a C++ constant expression of integers and bools: names from
    env (Pl::X, Items::X, ps.x and a.x read as X), casts dropped, integer
    division (every operand here is >= 0)."""
    e = expr.replace("blockIdx.x", "block")
    e = re.sub(r"\b\w+::", "", e)
    e = re.sub(r"\b(?:ps|a)\.", "", e)
    e = re.sub(r"\((?:long long|int|unsigned|size_t)\)", "", e)
    e = e.replace("&&", " and ").replace("||", " or ")
    e = re.sub(r"!(?!=)", " not ", e)
    e = re.sub(r"\btrue\b", "True", re.sub(r"\bfalse\b", "False", e))
    e = re.sub(r"(?<!/)/(?!/)", "//", e)
    return int(eval(_ternary(e), {"__builtins__": {}}, env))


def _split(text: str) -> list:
    """text split at its commas outside () and {}."""
    out, depth, start = [], 0, 0
    for i, ch in enumerate(text + ","):
        depth += (ch in "({") - (ch in ")}")
        if ch == "," and depth == 0:
            out.append(text[start:i].strip())
            start = i + 1
    return out


def c_constants(text: str) -> dict:
    """{name: expr} of every `[static] constexpr int|bool A = x, B = y;` in text."""
    out = {}
    for decl in re.findall(r"constexpr (?:int|bool) ([^;(]+=[^;]+);", text):
        out.update(tuple(s.strip() for s in d.split("=", 1)) for d in _split(decl))
    return out


def c_block(text: str, head: str) -> str:
    """The text inside the braces that follow the first match of regex head."""
    start = text.index("{", re.search(head, text).end()) + 1
    depth = 1
    for i in range(start, len(text)):
        depth += (text[i] == "{") - (text[i] == "}")
        if depth == 0:
            return text[start:i]
    raise ValueError(f"unbalanced braces after {head}")


class CEnv(dict):
    """Values of names by their C expressions, each evaluated when first read;
    names it has no expression for come from ``parent``."""

    def __init__(self, exprs: dict, parent=None, **values):
        super().__init__(values)
        self.exprs, self.parent = exprs, parent

    def __missing__(self, name):
        if name in self.exprs:
            self[name] = c_eval(self.exprs[name], self)
            return self[name]
        if self.parent is None:
            raise KeyError(name)
        return self.parent[name]


def _factor(header: str, env) -> int:
    """How many times a loop header or a constexpr guard runs what follows it."""
    header = re.sub(r"^(?:#pragma unroll(?: \d+)? )+", "", header)
    m = re.fullmatch(r"for \(int (\w+) = 0; \1 < (.+); (?:\+\+\1|\1 \+= (.+))\)", header)
    if m:
        return -(-c_eval(m[2], env) // (c_eval(m[3], env) if m[3] else 1))
    m = re.fullmatch(r"if constexpr \((.+)\)", header)
    if m:
        return int(bool(c_eval(m[1], env)))
    raise ValueError(f"cannot count the runs of {header!r}")


def c_calls(body: str, call: str, env) -> list:
    """Each call of regex ``call`` in body, with its arguments' text and the
    times it runs in one run of body: the product of the loops and constexpr
    guards around it, with braces or without.  [(args, times), ...]."""
    found = []
    for m in re.finditer(call + r"\(([^;]*)\);", body):
        stack, last, depth = [], 0, 0
        for i in range(m.start()):
            ch = body[i]
            depth += (ch == "(") - (ch == ")")
            if ch == "{":
                stack.append(body[last:i])
            elif ch == "}":
                stack.pop()
            if ch in "{}" or (ch == ";" and depth == 0):
                last = i + 1
        heads = [" ".join(h.split()) for h in stack]
        stmt = " ".join(body[last:m.start()].split())
        for k in re.finditer(r"(?:for|if constexpr) \(", stmt):
            heads.append(stmt[k.start():_parens(stmt, k.end() - 1)])
        times = 1
        for h in heads:
            times *= _factor(h, env)
        found.append((m[1], times))
    return found


def c_enums(text: str) -> dict:
    """{name: value} of every enum's explicit `name = value` in text."""
    return {k: int(v) for body in re.findall(r"enum \w*\s*\{([^}]*)\}", text)
            for k, v in re.findall(r"(\w+) = (\d+)", body)}


def c_plan_env(src: str, plan: str, args: tuple, **values) -> CEnv:
    """The constants of struct template ``plan`` of file ``src`` at template
    arguments ``args``, with those of the plans it derives from (their
    arguments bound as the source binds them), the namespace-level k-constants
    of attn_common.cuh, sm90.cuh and section_win.cuh, and the enums of src."""
    base = {}
    for f in ("attn_common.cuh", "sm90.cuh", "section_win.cuh"):
        base.update(re.findall(r"^constexpr int (k\w+) = ([^;]+);", csrc(f), re.M))
    text = {f: csrc(f) for f in ("section_sm90.cuh", "section_win.cuh", src)}
    env = CEnv({}, CEnv(base, **c_enums(text[src])), **values)
    name, vals = plan, [int(a) for a in args]
    while name:
        f = next(f for f, t in text.items() if re.search(rf"struct {name}\b", t))
        m = re.search(rf"template <([^>]*)>\s*struct {name}\s*(?::\s*(\w+)<([^{{]*)>)?\s*\{{",
                      text[f])
        params = [p.split()[-1] for p in _split(m[1])]
        env.update(zip(params, vals))
        env.exprs = {**c_constants(c_block(text[f], rf"struct {name}\b")), **env.exprs}
        name, vals = m[2], [c_eval(a, env) for a in _split(m[3])] if m[2] else []
    return env


def win_blocks(src: str, kernel: str, nw: int, wblk: int, w: int) -> list:
    """The windows of each pass of each block of K9's or K11's kernel ``kernel``
    in ``src`` (its grid, section_win.cuh's win_passes, the kernel's win0 and
    nwin): [[(first window, windows), ...] a block]."""
    text, win = csrc(src), csrc("section_win.cuh")
    grids = set(re.findall(r"grid = ([^;]+);", text))
    assert len(grids) == 1, grids
    fields = [f for d in re.findall(r"(?:long long|int) ([\w, ]+);",
                                    c_block(win, r"struct Passes\b")) for f in _split(d)]
    wp = c_block(win, r"Passes win_passes\(")
    body = c_block(c_block(text, rf"\b{kernel}\("), r"for \(int p = 0; p < ps\.npass; \+\+p\)")
    step = dict(re.findall(r"const (?:long long|int) (win0|nwin) = ([^;]+);", body))
    blocks = []
    for b in range(c_eval(grids.pop(), dict(NW=nw, wblk=wblk))):
        env = CEnv(dict(re.findall(r"const (?:long long|int) (\w+) = ([^;]+);", wp)),
                   block=b, wblk=wblk, NW=nw, W=w)
        ps = dict(zip(fields, (c_eval(e, env) for e in _split(
            re.search(r"return \{(.*)\};", wp)[1]))))
        passes = []
        for p in range(ps["npass"]):
            env_p = CEnv(step, p=p, W=w, **ps)
            passes.append((env_p["win0"], env_p["nwin"]))
        blocks.append(passes)
    return blocks


def win_takes(src: str, kernel: str, env) -> int:
    """Ring slots a consumer warpgroup of ``kernel`` takes a pass: its
    section_product calls (section_sm90.cuh: a slot a k_tile) and, in K11, its
    head_projection calls (the pieces it takes and skips), each times the loops
    and guards around it, from the sources."""
    sm = c_block(csrc("section_sm90.cuh"), r"void section_product\(")
    assert len(re.findall(r"\bring_take\(", c_block(sm, r"auto k_tile = \[&\]\("))) == 1
    product = sum(t for _, t in c_calls(sm, r"\bk_tile", env))
    text = csrc(src)
    body = c_block(c_block(text, rf"\b{kernel}\("), r"for \(int p = 0; p < ps\.npass; \+\+p\)")
    takes = sum(t * product for _, t in c_calls(body, r"\bsection_product<Pl>", env))
    calls = c_calls(body, r"\bhead_projection<Pl>", env)
    if calls:
        hp = c_block(text, r"void head_projection\(")
        head = sum(t for _, t in c_calls(hp, r"\bring_take", env))
        head += sum(t * c_eval(a.split(",", 1)[1], env) for a, t in c_calls(hp, r"\bring_skip", env))
        takes += sum(t * head for _, t in calls)
    return takes


def win_kernel_env(src: str, kernel: str, plan: str, args: tuple, **values) -> CEnv:
    """c_plan_env with the constexpr locals of ``kernel`` in ``src`` over it
    (those that only name the plan's own, C = Pl::C, left to the plan)."""
    env = c_plan_env(src, plan, args, **values)
    local = c_constants(c_block(csrc(src), rf"\b{kernel}\("))
    return CEnv({k: v for k, v in local.items() if re.sub(r"\b\w+::", "", v) != k}, env)


def win_stream(src: str, items: str, env) -> int:
    """Ring slots a pass that the stream of struct ``items`` in ``src`` fills (its PASS)."""
    return CEnv(c_constants(c_block(csrc(src), rf"struct {items}\b")), env)["PASS"]
