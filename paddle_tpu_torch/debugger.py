"""Program visualization / debugging aids: the port of
paddle_tpu/debugger.py (the same text for the same program).

reference: python/paddle/fluid/debugger.py + graphviz.py (program → dot),
framework/ir/graph_viz_pass.cc.
"""

from __future__ import annotations

from .core.program import Parameter, Program


def pprint_program_codes(program: Program) -> str:
    """Readable program listing (debugger.py pprint_program_codes)."""
    return str(program)


def draw_block_graphviz(block, path: str = None, highlights=None) -> str:
    """Emit a graphviz dot description of the block's dataflow
    (debugger.py draw_block_graphviz)."""
    lines = ["digraph G {", "  rankdir=TB;"]
    highlights = set(highlights or [])
    for name, var in block.vars.items():
        shape = "box" if isinstance(var, Parameter) else "ellipse"
        color = ', style=filled, fillcolor="#ffd37f"' \
            if name in highlights else ""
        label = f"{name}\\n{var.shape} {var.dtype}"
        lines.append(f'  "{name}" [shape={shape}, label="{label}"{color}];')
    for i, op in enumerate(block.ops):
        op_id = f"op_{i}_{op.type}"
        lines.append(
            f'  "{op_id}" [shape=record, style=filled, '
            f'fillcolor="#cde6ff", label="{op.type}"];')
        for n in op.desc.input_names():
            lines.append(f'  "{n}" -> "{op_id}";')
        for n in op.desc.output_names():
            lines.append(f'  "{op_id}" -> "{n}";')
    lines.append("}")
    dot = "\n".join(lines)
    if path:
        with open(path, "w") as f:
            f.write(dot)
    return dot
