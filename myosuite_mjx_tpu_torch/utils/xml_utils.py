"""MJCF surgery: comment-preserving parse, merge, and body reparenting.

Counterpart of ``myosuite_mjx_tpu/utils/xml_utils.py``, a copy of it: the
port imports nothing of the JAX package, not even its pure-Python modules.
Parse MJCF keeping comments, serialize back to a string, graft one MJCF's
sections into another (scene composition), and move a ``<body>`` subtree
under a new parent with attribute overrides (robot re-mounting). Lookups
use explicit ``is not None`` checks (an ElementTree element with no
children is falsy), and reparenting finds the old parent by element
identity, so nested bodies of one name are safe.
"""
from __future__ import annotations

import xml.etree.ElementTree as ET

_ORI_KEYS = ("quat", "euler", "axisangle", "xyaxes", "zaxis")


def parse_mjcf(path: str | None = None, xml_str: str | None = None):
  """Parse an MJCF document, preserving XML comments.

  ``xml_str`` wins when both are given (reference parity).
  Returns an ElementTree.
  """
  parser = ET.XMLParser(target=ET.TreeBuilder(insert_comments=True))
  if xml_str is not None:
    return ET.ElementTree(ET.fromstring(xml_str, parser=parser))
  if path is None:
    raise ValueError("either path or xml_str is required")
  return ET.parse(path, parser=parser)


def to_xml_str(tree_or_elem, pretty: bool = False) -> str:
  """Serialize an ElementTree or Element to a unicode XML string."""
  elem = (tree_or_elem.getroot()
          if isinstance(tree_or_elem, ET.ElementTree) else tree_or_elem)
  if pretty:
    ET.indent(elem)
  return ET.tostring(elem, encoding="unicode")


def merge_mjcf(receiver, donor, receiver_node: str | None = None,
               destination: str = "str"):
  """Graft every top-level child of ``donor`` into ``receiver``.

  receiver/donor: file paths or raw XML strings (auto-detected by a
  leading '<'). receiver_node: XPath of the element the donor children
  are appended to (default: document root). destination: "str" | "tree".
  """
  def _load(src):
    if isinstance(src, str) and src.lstrip().startswith("<"):
      return parse_mjcf(xml_str=src)
    return parse_mjcf(path=src)

  rtree = _load(receiver)
  target = rtree.find(receiver_node) if receiver_node else rtree.getroot()
  if target is None:
    raise ValueError(f"receiver node {receiver_node!r} not found")
  for child in list(_load(donor).getroot()):
    target.append(child)
  return to_xml_str(rtree) if destination == "str" else rtree


def _find_parent(root: ET.Element, child: ET.Element):
  for parent in root.iter():
    for c in parent:
      if c is child:
        return parent
  return None


def reparent_body(path: str | None = None, xml_str: str | None = None,
                  new_parent: str | None = None, body: str | None = None,
                  overrides: dict | None = None, destination: str = "str"):
  """Move ``<body name=body>`` under ``<body name=new_parent>``.

  overrides: attributes set on the moved body; specifying any orientation
  key (quat/euler/axisangle/...) first clears every other orientation key
  so MuJoCo's one-orientation-spec rule holds.
  """
  tree = parse_mjcf(path=path, xml_str=xml_str)
  root = tree.getroot()
  target = root.find(f".//body[@name='{new_parent}']")
  if target is None:
    raise ValueError(f"new parent body {new_parent!r} not found")
  moved = root.find(f".//body[@name='{body}']")
  if moved is None:
    raise ValueError(f"body {body!r} not found")

  for key, val in (overrides or {}).items():
    if key in _ORI_KEYS:
      for ori in _ORI_KEYS:
        moved.attrib.pop(ori, None)
    moved.set(key, val)

  old_parent = _find_parent(root, moved)
  if old_parent is None:
    raise ValueError(f"body {body!r} has no parent (is it the root?)")
  if old_parent is not target:
    target.append(moved)
    old_parent.remove(moved)
  return to_xml_str(tree) if destination == "str" else tree
