"""Synthetic muscle-tendon hand scenes at MyoHand's width.

``hand_fixture_xml(digits)`` returns MJCF text for a fixed forearm, a wrist
with three hinge dofs, a thumb with four and ``digits - 1`` fingers with four
each, in MyoHand's joint order (pro_sup, deviation, flexion, cmc_abduction,
cmc_flexion, mp_flexion, ip_flexion, then mcpN_flexion, mcpN_abduction,
pmN_flexion, mdN_flexion for each finger). Bones are capsules with joint
limits, damping and armature over a ground plane.

Each distal phalanx carries a massless site at its far end, named as
MyoHand's fingertip sites (``THtip``, ``IFtip``, ``MFtip``, ``RFtip``,
``LFtip``), for the reach tasks.

Every actuator is a muscle on a spatial tendon routed over sites. The
routes use sphere wraps with and without a side site, cylinder wraps with a
side site outside the geom, and one cylinder wrap whose side site lies
inside the geom (the inside-wrap path). Wrap geoms never collide. The only
colliding pairs are capsule-capsule between neighbouring digits and
capsule-plane for the fingertips; radii, spacings and lengths differ from
digit to digit so that no two candidate pairs are mirror images.

``digits=5`` gives hand23 (nv 23, nu = na = 39: wrist 6, thumb 9 and four
fingers of 6 muscles), the width of MyoHand. ``digits=2`` gives hand11
(nv 11, nu 21), small enough for the CPU parity tests.

``free_fixture_xml()`` is a small rigid-body scene for ball and free joints
and mocap bodies (see its docstring).
"""
from __future__ import annotations

import math

import numpy as np

# per finger (index, middle, ring, little): y offset of the knuckle, capsule
# radius, and the lengths of the proximal, middle and distal phalanges
_FINGERS = (
    (0.0185, 0.0088, 0.041, 0.026, 0.019),
    (-0.0012, 0.0091, 0.044, 0.028, 0.020),
    (-0.0207, 0.0085, 0.042, 0.026, 0.0185),
    (-0.0398, 0.0079, 0.035, 0.021, 0.017),
)
_THUMB_LEN = (0.035, 0.030, 0.022)
# MyoHand's fingertip site names, for fingers k = 2 (index) ... 5 (little);
# the thumb's is THtip
_TIPS = {2: "IFtip", 3: "MFtip", 4: "RFtip", 5: "LFtip"}
_THUMB_RADIUS = 0.0095
# object scenes: the forearm's height; the contype bits of the palm pad and
# of an object. An object collides with every digit (the bones' contype
# bits 2-6), the palm pad and the plane (bit 0).
_TURNED_HEIGHT = 0.09
_PALM_BIT = 1 << 8
_OBJECT_BIT = 1 << 9
_DIGIT_BITS = sum(1 << (d + 1) for d in range(1, 6))
# the arm scenes' nails and the prosthesis's fingers
_NAIL_BIT = 1 << 10
_PROSTHESIS_BIT = 1 << 11


def _f(*xs: float) -> str:
  return " ".join(f"{x:.6g}" for x in xs)


def _phalanx_inertial(mass: float, length: float, radius: float) -> str:
  ixx = 0.5 * mass * radius * radius
  iyy = mass * (3 * radius * radius + length * length) / 12.0
  return (f'<inertial pos="{_f(0.5 * length, 0, 0)}" mass="{mass:.6g}" '
          f'diaginertia="{_f(ixx, iyy, iyy * 1.07)}"/>')


def _capsule(name: str, length: float, radius: float, contype: int,
             conaffinity: int, margin: float = 0.0) -> str:
  extra = f' margin="{margin:.6g}"' if margin else ""
  return (f'<geom name="{name}" type="capsule" fromto="{_f(0, 0, 0, length, 0, 0)}" '
          f'size="{radius:.6g}" contype="{contype}" conaffinity="{conaffinity}"'
          f'{extra}/>')


def _bits(digit: int, distal: bool) -> tuple[int, int]:
  """contype/conaffinity: digit i collides with digits i-1 and i+1 only;
  fingertips also collide with the plane (bit 0)."""
  contype = 1 << (digit + 1)
  conaffinity = (1 << digit) | (1 << (digit + 2))
  return contype | (1 if distal else 0), conaffinity


def _nail(name: str, length: float, radius: float) -> str:
  """A small ellipsoid nail on the dorsal side of a distal phalanx's tip;
  it collides with the arm scenes' objects only."""
  return (f'\n            <geom name="{name}" type="ellipsoid" '
          f'pos="{_f(length - 0.004, 0, 0.7 * radius)}" '
          f'size="{_f(0.005, 0.4 * radius + 0.001, 0.0015)}" '
          f'contype="{_NAIL_BIT}" conaffinity="0"/>')


def _thumb_body(nails: bool = False) -> str:
  l0, l1, l2 = _THUMB_LEN
  r = _THUMB_RADIUS
  ct0, ca0 = _bits(1, False)
  ct2, ca2 = _bits(1, True)
  return f"""
      <body name="thumb_meta" pos="0.012 0.026 -0.006" euler="0.1 0.25 0.55">
        {_phalanx_inertial(0.016, l0, r)}
        <joint name="cmc_abduction" axis="0.2 0 1" range="-0.6 0.8" damping="0.02" armature="0.0002"/>
        <joint name="cmc_flexion" axis="0 1 0.3" range="-0.6 0.8" damping="0.02" armature="0.0002"/>
        {_capsule("thumb_meta_bone", l0, r, ct0, ca0)}
        <geom name="thumb_mp_wrap" type="cylinder" pos="{_f(l0, 0, 0)}" zaxis="0 1 0" size="0.0062 0.007" contype="0" conaffinity="0"/>
        <site name="thumb_mp_side_in" pos="{_f(l0, 0, 0.0021)}"/>
        <site name="thumb_meta_fpl" pos="0.015 0 -0.0105"/>
        <site name="thumb_meta_epl" pos="0.02 0.0005 0.0108"/>
        <site name="thumb_meta_apl" pos="0.01 0.0105 0.001"/>
        <site name="thumb_meta_op" pos="0.025 -0.006 -0.0085"/>
        <site name="thumb_meta_fpb2" pos="0.03 0.0085 -0.006"/>
        <body name="thumb_prox" pos="{_f(l0, 0, 0)}">
          {_phalanx_inertial(0.011, l1, r * 0.95)}
          <joint name="mp_flexion" axis="0 1 0" range="-1.0 0.6" damping="0.015" armature="0.00015"/>
          {_capsule("thumb_prox_bone", l1, r * 0.95, ct0, ca0)}
          <site name="thumb_prox_fpl" pos="0.015 0 -0.0098"/>
          <site name="thumb_prox_epl" pos="0.012 0 0.0097"/>
          <site name="thumb_prox_epb" pos="0.008 0.0015 0.0099"/>
          <site name="thumb_prox_apb" pos="0.008 0.0085 -0.0045"/>
          <site name="thumb_prox_fpb" pos="0.009 0.001 -0.0099"/>
          <site name="thumb_prox_adp" pos="0.006 -0.0088 -0.004"/>
          <body name="thumb_dist" pos="{_f(l1, 0, 0)}">
            {_phalanx_inertial(0.007, l2, r * 0.9)}
            <joint name="ip_flexion" axis="0 1 0.1" range="-0.9 0.8" damping="0.01" armature="0.0001"/>
            {_capsule("thumb_dist_bone", l2, r * 0.9, ct2, ca2, margin=0.001)}{_nail("thumb_nail", l2, r * 0.9) if nails else ""}
            <site name="THtip" pos="{_f(l2, 0, 0)}"/>
            <site name="thumb_dist_fpl" pos="0.01 0 -0.0092"/>
            <site name="thumb_dist_epl" pos="0.01 0 0.0091"/>
          </body>
        </body>
      </body>"""


def _finger_body(k: int, y: float, r: float, l0: float, l1: float,
                 l2: float, nails: bool = False) -> str:
  """Finger k (2 = index ... 5 = little) on the palm."""
  digit = k
  ct, ca = _bits(digit, False)
  ctd, cad = _bits(digit, True)
  return f"""
      <body name="f{k}_prox" pos="{_f(0.08, y, 0)}">
        {_phalanx_inertial(0.012 + 0.001 * k, l0, r)}
        <joint name="mcp{k}_flexion" axis="0 1 0" range="-0.3 1.5" damping="0.012" armature="0.00012"/>
        <joint name="mcp{k}_abduction" axis="0 0 1" range="-0.3 0.3" damping="0.012" armature="0.00012"/>
        {_capsule(f"f{k}_prox_bone", l0, r, ct, ca)}
        <geom name="f{k}_pip_wrap" type="sphere" pos="{_f(l0, 0, 0)}" size="0.0052" contype="0" conaffinity="0"/>
        <site name="f{k}_prox_fdp_a" pos="0.01 0 -0.0112"/>
        <site name="f{k}_prox_fdp_b" pos="{_f(l0 - 0.008, 0, -0.0112)}"/>
        <site name="f{k}_prox_fds" pos="0.02 0.0005 -0.0118"/>
        <site name="f{k}_prox_edc" pos="0.012 0 0.0105"/>
        <site name="f{k}_prox_ri" pos="0.012 0.0085 -0.0035"/>
        <site name="f{k}_prox_ui" pos="0.011 -0.0088 -0.0032"/>
        <site name="f{k}_prox_lum" pos="0.016 -0.0064 -0.0072"/>
        <body name="f{k}_mid" pos="{_f(l0, 0, 0)}">
          {_phalanx_inertial(0.007 + 0.0005 * k, l1, r * 0.95)}
          <joint name="pm{k}_flexion" axis="0 1 0" range="-0.2 1.5" damping="0.01" armature="0.0001"/>
          {_capsule(f"f{k}_mid_bone", l1, r * 0.95, ct, ca)}
          <site name="f{k}_mid_fdp" pos="{_f(0.5 * l1, 0, -0.0101)}"/>
          <site name="f{k}_mid_fds" pos="0.011 0.0004 -0.0103"/>
          <site name="f{k}_mid_edc" pos="{_f(0.5 * l1, 0, 0.0099)}"/>
          <body name="f{k}_dist" pos="{_f(l1, 0, 0)}">
            {_phalanx_inertial(0.005 + 0.0004 * k, l2, r * 0.9)}
            <joint name="md{k}_flexion" axis="0 1 0" range="-0.2 1.4" damping="0.008" armature="0.00008"/>
            {_capsule(f"f{k}_dist_bone", l2, r * 0.9, ctd, cad, margin=0.001)}{_nail(f"f{k}_nail", l2, r * 0.9) if nails else ""}
            <site name="{_TIPS[k]}" pos="{_f(l2, 0, 0)}"/>
            <site name="f{k}_dist_fdp" pos="0.009 0 -0.0093"/>
            <site name="f{k}_dist_edc" pos="0.009 0 0.0092"/>
          </body>
        </body>
      </body>"""


def _finger_palm_parts(k: int, y: float) -> str:
  """Wrap geoms and origin sites a finger's muscles need on the palm."""
  return f"""
      <geom name="f{k}_mcp_wrap" type="cylinder" pos="{_f(0.08, y, 0)}" zaxis="0 1 0" size="0.0061 0.008" contype="0" conaffinity="0"/>
      <site name="f{k}_mcp_side" pos="{_f(0.08, y, 0.021)}"/>
      <site name="f{k}_palm_fdp" pos="{_f(0.05, y + 0.0006, -0.0121)}"/>
      <site name="f{k}_palm_fds" pos="{_f(0.045, y - 0.0007, -0.0132)}"/>
      <site name="f{k}_palm_edc" pos="{_f(0.05, y, 0.0122)}"/>
      <site name="f{k}_palm_ri" pos="{_f(0.06, y + 0.0091, -0.0048)}"/>
      <site name="f{k}_palm_ui" pos="{_f(0.061, y - 0.0093, -0.0051)}"/>
      <site name="f{k}_palm_lum" pos="{_f(0.055, y - 0.0041, -0.0141)}"/>"""


def _finger_tendons(k: int) -> str:
  return f"""
    <spatial name="FDP{k}_t"><site site="f{k}_palm_fdp"/><site site="f{k}_prox_fdp_a"/><site site="f{k}_prox_fdp_b"/><site site="f{k}_mid_fdp"/><site site="f{k}_dist_fdp"/></spatial>
    <spatial name="FDS{k}_t"><site site="f{k}_palm_fds"/><site site="f{k}_prox_fds"/><geom geom="f{k}_pip_wrap"/><site site="f{k}_mid_fds"/></spatial>
    <spatial name="EDC{k}_t"><site site="f{k}_palm_edc"/><geom geom="f{k}_mcp_wrap" sidesite="f{k}_mcp_side"/><site site="f{k}_prox_edc"/><site site="f{k}_mid_edc"/><site site="f{k}_dist_edc"/></spatial>
    <spatial name="RI{k}_t"><site site="f{k}_palm_ri"/><site site="f{k}_prox_ri"/></spatial>
    <spatial name="UI{k}_t"><site site="f{k}_palm_ui"/><site site="f{k}_prox_ui"/></spatial>
    <spatial name="LUM{k}_t"><site site="f{k}_palm_lum"/><site site="f{k}_prox_lum"/></spatial>"""


_WRIST_TENDONS = """
    <spatial name="FCR_t"><site site="fa_fcr"/><geom geom="wrist_wrap" sidesite="wrist_side"/><site site="palm_fcr"/></spatial>
    <spatial name="FCU_t"><site site="fa_fcu"/><site site="palm_fcu"/></spatial>
    <spatial name="ECRL_t"><site site="fa_ecrl"/><site site="palm_ecrl"/></spatial>
    <spatial name="ECU_t"><site site="fa_ecu"/><geom geom="wrist_wrap_d"/><site site="palm_ecu"/></spatial>
    <spatial name="PT_t"><site site="fa_pt"/><site site="rad_pt"/></spatial>
    <spatial name="SUP_t"><site site="fa_sup"/><site site="rad_sup"/></spatial>"""

_THUMB_TENDONS = """
    <spatial name="FPL_t"><site site="fa_fpl"/><site site="palm_fpl"/><site site="thumb_meta_fpl"/><site site="thumb_prox_fpl"/><site site="thumb_dist_fpl"/></spatial>
    <spatial name="EPL_t"><site site="fa_epl"/><site site="palm_epl"/><site site="thumb_meta_epl"/><geom geom="thumb_mp_wrap" sidesite="thumb_mp_side_in"/><site site="thumb_prox_epl"/><site site="thumb_dist_epl"/></spatial>
    <spatial name="EPB_t"><site site="fa_epb"/><site site="palm_epb"/><site site="thumb_prox_epb"/></spatial>
    <spatial name="APL_t"><site site="fa_apl"/><site site="thumb_meta_apl"/></spatial>
    <spatial name="APB_t"><site site="palm_apb"/><site site="thumb_prox_apb"/></spatial>
    <spatial name="FPB_t"><site site="palm_fpb"/><site site="thumb_prox_fpb"/></spatial>
    <spatial name="OP_t"><site site="palm_op"/><site site="thumb_meta_op"/></spatial>
    <spatial name="ADP_t"><site site="palm_adp"/><site site="thumb_prox_adp"/></spatial>
    <spatial name="FPB2_t"><site site="palm_fpb2"/><site site="thumb_meta_fpb2"/></spatial>"""

_WRIST_MUSCLES = ("FCR", "FCU", "ECRL", "ECU", "PT", "SUP")
_THUMB_MUSCLES = ("FPL", "EPL", "EPB", "APL", "APB", "FPB", "OP", "ADP", "FPB2")
_FINGER_MUSCLES = ("FDP", "FDS", "EDC", "RI", "UI", "LUM")


def _muscle(name: str, force: float) -> str:
  return (f'<muscle name="{name}" tendon="{name}_t" force="{force:.6g}" '
          f'ctrlrange="0 1"/>')


def _hand_parts(digits: int, nails: bool = False):
  """The hand's palm parts and digit bodies, its tendons and its muscles
  (MJCF fragments)."""
  if not 1 <= digits <= 5:
    raise ValueError(f"digits must be in 1..5, got {digits}")
  fingers = [(k, *_FINGERS[k - 2]) for k in range(2, digits + 1)]
  palm_parts = "".join(_finger_palm_parts(k, y) for k, y, *_ in fingers)
  bodies = _thumb_body(nails) + "".join(_finger_body(*f, nails=nails)
                                        for f in fingers)
  tendons = (_WRIST_TENDONS + _THUMB_TENDONS
             + "".join(_finger_tendons(k) for k, *_ in fingers))
  muscles = [_muscle(n, 18.0 + 2.0 * i) for i, n in enumerate(_WRIST_MUSCLES)]
  muscles += [_muscle(n, 9.0 + 0.5 * i) for i, n in enumerate(_THUMB_MUSCLES)]
  for k, *_ in fingers:
    muscles += [_muscle(f"{n}{k}", 7.0 + 0.6 * i + 0.2 * k)
                for i, n in enumerate(_FINGER_MUSCLES)]
  return palm_parts, bodies, tendons, "\n    ".join(muscles)


def _forearm_body(digits: int, forearm: str, pro_sup: str, palm: str = "",
                  inner: str = "", nails: bool = False,
                  wrist_spring: str = "") -> tuple[str, str, str]:
  """The forearm body (attributes ``forearm``) down to the fingertips, its
  tendons and muscles. ``pro_sup`` holds the pronation joint's axis and
  range, ``palm`` extra MJCF inside the palm body, ``inner`` extra MJCF
  inside the forearm body (after its inertial), ``wrist_spring`` extra
  attributes of the three wrist joints (a spring)."""
  palm_parts, bodies, tendons, actuators = _hand_parts(digits, nails)
  ws = f" {wrist_spring}" if wrist_spring else ""
  body = f"""
    <body name="forearm" {forearm}>
      <inertial pos="0.06 0 0" mass="0.3" diaginertia="0.00004 0.0004 0.0004"/>{inner}
      <geom name="forearm_bone" type="capsule" fromto="0 0 0 0.11 0 0" size="0.016" contype="0" conaffinity="0"/>
      <site name="fa_fcr" pos="0.03 0.0102 -0.0185"/>
      <site name="fa_fcu" pos="0.031 -0.0121 -0.0181"/>
      <site name="fa_ecrl" pos="0.03 0.0113 0.0184"/>
      <site name="fa_ecu" pos="0.032 -0.0109 0.0182"/>
      <site name="fa_pt" pos="0.02 -0.021 0.0012"/>
      <site name="fa_sup" pos="0.021 0.0205 -0.0011"/>
      <site name="fa_fpl" pos="0.04 0.0121 -0.0187"/>
      <site name="fa_epl" pos="0.041 0.0062 0.0189"/>
      <site name="fa_epb" pos="0.045 0.0152 0.0162"/>
      <site name="fa_apl" pos="0.05 0.0203 0.0006"/>
      <body name="radius" pos="0 0 0">
        <inertial pos="0.07 0 0" mass="0.05" diaginertia="0.000006 0.00008 0.00008"/>
        <joint name="pro_sup" {pro_sup} damping="0.03" armature="0.0004"{ws}/>
        <geom name="radius_bone" type="capsule" fromto="0.06 0 0 0.11 0 0" size="0.011" contype="0" conaffinity="0"/>
        <geom name="wrist_wrap" type="sphere" pos="0.118 0 -0.001" size="0.0082" contype="0" conaffinity="0"/>
        <geom name="wrist_wrap_d" type="sphere" pos="0.117 -0.004 0.002" size="0.0075" contype="0" conaffinity="0"/>
        <site name="wrist_side" pos="0.118 0 -0.021"/>
        <site name="rad_pt" pos="0.08 0.0007 0.0132"/>
        <site name="rad_sup" pos="0.081 -0.0006 -0.0128"/>
        <body name="palm" pos="0.12 0 0">
          <inertial pos="0.04 -0.004 0" mass="0.07" diaginertia="0.000012 0.00004 0.00005"/>
          <joint name="deviation" axis="0 0 1" range="-0.25 0.35" damping="0.03" armature="0.0003"{ws}/>
          <joint name="flexion" axis="0 1 0" range="-0.8 0.8" damping="0.03" armature="0.0003"{ws}/>
          <geom name="palm_bone" type="capsule" fromto="0.005 -0.01 0 0.07 -0.01 0" size="0.024" contype="0" conaffinity="0"/>
          <site name="palm_fcr" pos="0.025 0.012 -0.0122"/>
          <site name="palm_fcu" pos="0.02 -0.018 -0.0119"/>
          <site name="palm_ecrl" pos="0.025 0.013 0.0121"/>
          <site name="palm_ecu" pos="0.021 -0.017 0.0118"/>
          <site name="palm_fpl" pos="0.015 0.02 -0.0125"/>
          <site name="palm_epl" pos="0.014 0.022 0.0123"/>
          <site name="palm_epb" pos="0.012 0.025 0.0101"/>
          <site name="palm_apb" pos="0.02 0.0142 -0.0128"/>
          <site name="palm_fpb" pos="0.026 0.005 -0.0131"/>
          <site name="palm_op" pos="0.019 0.001 -0.0135"/>
          <site name="palm_adp" pos="0.05 -0.01 -0.0122"/>
          <site name="palm_fpb2" pos="0.03 0.0152 -0.0117"/>{palm}{palm_parts}{bodies}
        </body>
      </body>
    </body>"""
  return body, tendons, actuators


def _scene(name: str, worldbody: str, tendons: str, actuators: str,
           asset: str = "", extra: str = "") -> str:
  """An MJCF document: the hand scenes' compiler and options, a floor
  plane, then ``worldbody``; ``extra`` follows the actuators
  (keyframes)."""
  asset = f"\n  <asset>{asset}\n  </asset>" if asset else ""
  return f"""<mujoco model="{name}">
  <compiler angle="radian" autolimits="true"/>
  <option timestep="0.002" iterations="100" ls_iterations="50"/>{asset}
  <worldbody>
    <geom name="floor" type="plane" size="0.5 0.5 0.05" contype="1" conaffinity="1"/>{worldbody}
  </worldbody>
  <tendon>{tendons}
  </tendon>
  <actuator>
    {actuators}
  </actuator>{extra}
</mujoco>
"""


def hand_fixture_xml(digits: int = 5, obj: str = "") -> str:
  """MJCF text of the synthetic hand: a thumb plus ``digits - 1`` fingers.

  With ``obj`` (worldbody MJCF of one object, see the object fixtures
  below) the hand is the object scenes' variant: the forearm is raised
  and turned thumb-up, as MyoHand's neutral posture, and pronation turns
  the other way, so that pro_sup = -1.5 (the tasks' palm-up init) turns
  the palm up; pro_sup's range reaches -1.6; a colliding pad lies on the
  palm; ``obj`` follows the hand in the worldbody.
  """
  if obj:
    forearm = f'pos="0 0 {_TURNED_HEIGHT:.6g}" euler="1.5708 0 0"'
    pro_sup = 'axis="-1 0 0" range="-1.6 1.0"'
    palm_pad = f"""
          <geom name="palm_pad" type="capsule" fromto="0.012 -0.01 -0.006 0.062 -0.01 -0.006" size="0.02" contype="{_PALM_BIT}" conaffinity="0"/>"""
  else:
    forearm = 'pos="0 0 0.052"'
    pro_sup = 'axis="1 0 0" range="-1.0 1.0"'
    palm_pad = ""
  body, tendons, actuators = _forearm_body(digits, forearm, pro_sup,
                                           palm_pad)
  return _scene(f"hand_fixture_{digits}", body + obj, tendons, actuators)


def free_fixture_xml() -> str:
  """MJCF text of the ball/free/mocap scene ("free10": nq 12, nv 10).

  - a hinge-ball chain of two capsules hanging from a fixed point, tilted
    so that it swings under gravity (hinge about y, then a ball joint);
  - a free body of two crossed capsules that falls onto the plane across
    a bar and comes to rest touching both (a lone capsule would roll on
    for ever: the pyramidal cone has no rolling friction);
  - the bar: a capsule on a mocap body lying on the plane (it collides
    with the free body only). ``Data.mocap_pos`` starts at the origin, as
    in the reference's ``make_data``: set it to (0, 0, 0.015) to lay the
    bar on the plane.

  Only plane-capsule and capsule-capsule pairs, the ported narrowphase.
  The chain collides with nothing. Hinge and ball joints are damped, so
  the integrator takes the implicit solve; the free joint is not.
  """
  return """<mujoco model="free_fixture">
  <compiler angle="radian" autolimits="true"/>
  <option timestep="0.002" iterations="100" ls_iterations="50"/>
  <worldbody>
    <geom name="floor" type="plane" size="0.5 0.5 0.05" contype="1" conaffinity="1"/>
    <body name="chain_root" pos="0.3 0 0.3" euler="0 0.6 0">
      <joint name="swing" type="hinge" axis="0 1 0" damping="0.002" armature="0.0001"/>
      <geom name="link1" type="capsule" fromto="0 0 0 0 0 -0.1" size="0.012" contype="2" conaffinity="0"/>
      <body name="chain_tip" pos="0 0 -0.1" euler="0.5 0 0.3">
        <joint name="wrist" type="ball" damping="0.001" armature="0.00005"/>
        <geom name="link2" type="capsule" fromto="0 0 0 0.02 0 -0.08" size="0.01" contype="2" conaffinity="0"/>
        <site name="chain_end" pos="0.02 0 -0.08"/>
      </body>
    </body>
    <body name="rod" pos="0.06 0.004 0.06" euler="0.05 0.1 0.2">
      <freejoint name="rod_free"/>
      <geom name="rod_geom" type="capsule" fromto="-0.08 0 0 0.08 0 0" size="0.01" contype="1" conaffinity="5"/>
      <geom name="rod_cross" type="capsule" fromto="0.03 -0.05 0 0.03 0.05 0" size="0.01" contype="1" conaffinity="5"/>
      <site name="rod_end" pos="0.08 0 0"/>
    </body>
    <body name="bar" mocap="true" pos="0 0 0.015">
      <geom name="bar_geom" type="capsule" fromto="0 -0.1 0 0 0.1 0" size="0.015" contype="4" conaffinity="0"/>
    </body>
  </worldbody>
</mujoco>
"""


# ---------------------------------------------------------------------------
# hand-object scenes: the hand of hand_fixture_xml(digits, obj) plus one
# object. The palm-up tasks (hold, pen, die) start at pro_sup = -1.5 with
# every other hand joint at 0; there the palm pad's top lies near
# (0.157, 0.010, 0.115) and the fingers' tops near z = 0.099. Each object
# starts 1.5-4 mm above the palm and falls onto it.
# ---------------------------------------------------------------------------

_OBJ = f'contype="{_OBJECT_BIT}" conaffinity="{1 | _DIGIT_BITS | _PALM_BIT}"'


def key_fixture_xml(digits: int = 5) -> str:
  """A key on a hinge, the last dof, between the thumb and index tips of
  the open hand (every hand joint at 0, thumb up): a box bow whose faces
  look at the two tips, about 5 cm from each, and a cylinder shaft along
  the hinge. ``keyhead`` sits at the bow's centre. The key collides with
  the digits and the palm (capsule-box, capsule-cylinder), not the plane.
  hand23: nv 24."""
  key = f"""
    <body name="key" pos="0.245 0.0098 0.1358" xyaxes="0.8165 -0.1959 -0.543 -0.5538 0 -0.8327">
      <joint name="key_hinge" axis="0 0 1" damping="0.002" armature="0.00002"/>
      <geom name="key_bow" type="box" size="0.003 0.012 0.012" density="2000" contype="{_OBJECT_BIT}" conaffinity="{_DIGIT_BITS | _PALM_BIT}"/>
      <geom name="key_shaft" type="cylinder" fromto="0 0 0.012 0 0 0.05" size="0.004" density="2000" contype="{_OBJECT_BIT}" conaffinity="{_DIGIT_BITS | _PALM_BIT}"/>
      <site name="keyhead"/>
    </body>"""
  return hand_fixture_xml(digits, key)


def hold_fixture_xml(digits: int = 5) -> str:
  """A free ellipsoid over the palm, the last joint and the last geom
  (``ObjHoldRandom`` overlays ``geom_size[-1]``), with an ``object`` site
  at its centre, and a ``goal`` site on a static body 2 cm above where
  the object starts. hand23: nv 29."""
  obj = f"""
    <body name="goal" pos="0.17 0.005 0.165">
      <site name="goal" size="0.01"/>
    </body>
    <body name="object" pos="0.17 0.005 0.145">
      <freejoint name="object_free"/>
      <geom name="object" type="ellipsoid" size="0.024 0.021 0.026" mass="0.05" {_OBJ}/>
      <site name="object"/>
    </body>"""
  return hand_fixture_xml(digits, obj)


def pen_fixture_xml(digits: int = 5) -> str:
  """A cylinder pen across the palm on six scalar joints (slides along
  x, y, z, then hinges about x, y, z of its frame), the last six dofs, not
  a free joint; ``object_top`` and ``object_bottom`` at its ends. A
  static ``target`` body above carries ``target_top`` and
  ``target_bottom`` along the same axis; ``eps_ball``, the desired
  position, is where the pen starts. condim 4, as MyoSuite's pen. hand23:
  nv 29."""
  pen = f"""
    <site name="eps_ball" pos="0.17 0.004 0.125" size="0.075"/>
    <body name="target" pos="0.17 0.004 0.2" euler="1.5708 0 0">
      <site name="target_top" pos="0 0 0.055"/>
      <site name="target_bottom" pos="0 0 -0.055"/>
    </body>
    <body name="Object" pos="0.17 0.004 0.125" euler="1.5708 0 0">
      <joint name="pen_x" type="slide" axis="1 0 0"/>
      <joint name="pen_y" type="slide" axis="0 1 0"/>
      <joint name="pen_z" type="slide" axis="0 0 1"/>
      <joint name="pen_rx" type="hinge" axis="1 0 0" damping="0.0002" armature="0.00002"/>
      <joint name="pen_ry" type="hinge" axis="0 1 0" damping="0.0002" armature="0.00002"/>
      <joint name="pen_rz" type="hinge" axis="0 0 1" damping="0.0002" armature="0.00002"/>
      <geom name="pen" type="cylinder" size="0.008 0.055" mass="0.02" condim="4" {_OBJ}/>
      <site name="object_top" pos="0 0 0.055"/>
      <site name="object_bottom" pos="0 0 -0.055"/>
    </body>"""
  return hand_fixture_xml(digits, pen)


def die_fixture_xml(digits: int = 5) -> str:
  """A free die (a box) over the palm, the last joint, with ``object_o``
  at its centre; a static ``target`` body 6 cm above with ``target_o``
  at its origin. condim 4, as MyoChallenge's die. hand23: nv 29."""
  die = f"""
    <body name="target" pos="0.175 0.005 0.193">
      <site name="target_o" size="0.016"/>
    </body>
    <body name="die" pos="0.175 0.005 0.133">
      <freejoint name="die_free"/>
      <geom name="die" type="box" size="0.016 0.016 0.016" mass="0.108" condim="4" {_OBJ}/>
      <site name="object_o"/>
    </body>"""
  return hand_fixture_xml(digits, die)


def prims_fixture_xml() -> str:
  """Free bodies of every primitive type over a plane ("prims"): a sphere,
  a capsule, an ellipsoid, a cylinder and a box, and a sixth body that
  carries one geom of each type on a flat plate, so that every one of the
  20 ported pair types is a candidate (the plane with each type, each
  type with each, the same types between the sixth body and the others).
  The bodies start a few centimetres up and land on the plane and on each
  other. The round bodies, the capsule and the cylinder on their sides,
  have condim 6 (rolling friction stops them), the plate and its
  cylinder condim 4, the box condim 3. nv 36."""
  def body(name, pos, geoms):
    return f"""
    <body name="{name}" pos="{pos}">
      <freejoint/>{geoms}
    </body>"""
  g = '\n      <geom type="{}" size="{}" {}/>'
  roll = 'condim="6" friction="1 0.01 0.01"'
  spin = 'condim="4" friction="1 0.01 0.01"'
  bodies = "".join([
      body("ball", "0.0 0.0 0.05", g.format("sphere", "0.02", roll)),
      body("pill", "0.09 0.0 0.03",
           g.format("capsule", "0.015 0.03", 'euler="1.5708 0 0" ' + roll)),
      body("egg", "0.0 0.09 0.05",
           g.format("ellipsoid", "0.03 0.022 0.016", roll)),
      body("can", "-0.09 0.0 0.03",
           g.format("cylinder", "0.02 0.025", 'euler="1.5708 0 0" ' + roll)),
      body("brick", "0.0 -0.09 0.04", g.format("box", "0.03 0.02 0.015", "")),
      body("plate", "0.0 0.0 0.015",
           g.format("box", "0.06 0.06 0.006", spin)
           + '\n      <geom type="sphere" size="0.012" pos="0.035 0.035 0.018" '
           + roll + '/>'
           + '\n      <geom type="capsule" size="0.008 0.02" '
           'pos="-0.035 0.035 0.014" euler="0 1.5708 0" ' + roll + '/>'
           + '\n      <geom type="ellipsoid" size="0.015 0.01 0.008" '
           'pos="-0.035 -0.035 0.014" ' + roll + '/>'
           + '\n      <geom type="cylinder" size="0.01 0.008" '
           'pos="0.035 -0.035 0.014" ' + spin + '/>')])
  return f"""<mujoco model="prims_fixture">
  <compiler angle="radian" autolimits="true"/>
  <option timestep="0.002" iterations="100" ls_iterations="50"/>
  <worldbody>
    <geom name="floor" type="plane" size="0.5 0.5 0.05"/>{bodies}
  </worldbody>
</mujoco>
"""


# ---------------------------------------------------------------------------
# the two-leg scene (MyoLeg's joint names and width)
#
# Body frames follow the pelvis: x forward, y to the left, z up; the
# standing pelvis is yawed a quarter turn, so that it faces world +y, as
# MyoLeg's does. Hip at (0, +-0.085, -0.05) under the pelvis, femur 0.42 m,
# tibia 0.40 m, talus 0.04 m; every foot geom's lowest point lies 0.05 m
# under the calcaneus, so the standing pelvis is at 0.96 m.
# ---------------------------------------------------------------------------

_LEG_HIP = (0.0, 0.085, -0.05)
_FEMUR_LEN = 0.42
_TIBIA_LEN = 0.40
_TALUS_LEN = 0.04
_FOOT_DEPTH = 0.05
_PELVIS_HEIGHT = (-_LEG_HIP[2] + _FEMUR_LEN + _TIBIA_LEN + _TALUS_LEN
                  + _FOOT_DEPTH)
# the knee's anterior translation against its angle (metres against
# radians), MyoLeg's coupling in shape: a quartic through the origin
KNEE_POLYCOEF = (0.0, 0.012, -0.006, 0.0012, -0.0001)
# the terrain field: 100 x 100 cells over 10 m x 10 m, heights up to 1 m;
# its geom is turned half a turn about z and shifted so that the world
# origin lies on row 46, where the hilly and stair recipes of the terrain
# walk start at height zero, and walking along +y climbs them
_HFIELD = (100, 100, (5.0, 5.0, 1.0, 0.1))
_TERRAIN_POS = (0.0, -0.3535, 0.0)
_GROUND_BITS = 1
_FOOT_BITS = 2

# MyoLeg's knee: the joints coupled to ``knee_angle_<s>`` by joint
# equalities, as name, type, axis (the left leg's), range and the quartic
# polycoef against the knee angle; the patella carries the beta ones, the
# tibia the rest
_KNEE_PATELLA = (
    ("knee_angle_{s}_beta_translation2", "slide", (0, 0, 1), (-0.05, 0.05),
     (0.0, -0.012, 0.004, 0.0, 0.0)),
    ("knee_angle_{s}_beta_translation1", "slide", (1, 0, 0), (-0.05, 0.05),
     (0.0, 0.015, -0.005, 0.0, 0.0)),
    ("knee_angle_{s}_beta_rotation1", "hinge", (0, 1, 0), (-1.0, 1.0),
     (0.0, 0.45, -0.1, 0.0, 0.0)),
)
_KNEE_TIBIA = (
    ("knee_angle_{s}_translation2", "slide", (0, 0, 1), (-0.05, 0.05),
     (0.0, -0.004, 0.0015, 0.0, 0.0)),
    ("knee_angle_{s}_translation1", "slide", (1, 0, 0), (-0.05, 0.05),
     KNEE_POLYCOEF),
    ("knee_angle_{s}_rotation2", "hinge", (1, 0, 0), (-0.3, 0.3),
     (0.0, 0.05, -0.02, 0.0, 0.0)),
    ("knee_angle_{s}_rotation3", "hinge", (0, 0, 1), (-0.3, 0.3),
     (0.0, -0.04, 0.015, 0.0, 0.0)),
)


def _knee_joints(table: tuple, side: str) -> tuple:
  """``table``'s joints for ``side``: the right leg mirrors the left in
  the sagittal plane (a slide's y and a hinge's x and z axis flip)."""
  if side == "l":
    return tuple((n.format(s=side), *rest) for n, *rest in table)
  mirror = lambda kind, a: ((a[0], -a[1], a[2]) if kind == "slide"
                            else (-a[0], a[1], -a[2]))
  return tuple((n.format(s=side), kind, mirror(kind, axis), rng, coef)
               for n, kind, axis, rng, coef in table)


def _coupled_knee(side: str, patella_geom: str) -> tuple[str, str, str]:
  """MyoLeg's knee of one leg, as ``_leg`` takes it: (the tibia's joints:
  ``translation2``, ``translation1``, ``knee_angle``, ``rotation2``,
  ``rotation3``; the ``patella_<s>`` body in the femur with the three
  beta joints and the geom ``patella_geom``; the seven joint equalities
  against the knee angle)."""
  patella_j = _knee_joints(_KNEE_PATELLA, side)
  tibia_j = _knee_joints(_KNEE_TIBIA, side)
  coupled = lambda joints, extra: "".join(
      f"\n          {_joint_xml(n, k, a, r, extra)}"
      for n, k, a, r, _ in joints)
  knee = (coupled(tibia_j[:2], ' damping="20" armature="0.02"')
          + f'\n          <joint name="knee_angle_{side}" axis="0 1 0" '
            'range="0 2.0" damping="4" stiffness="300" armature="0.01"/>'
          + coupled(tibia_j[2:], ' damping="2" armature="0.01"'))
  patella = f"""
        <body name="patella_{side}" pos="{_f(0.05, 0, -_FEMUR_LEN + 0.02)}">
          <inertial pos="0 0 0" mass="0.05" diaginertia="0.00001 0.00001 0.00001"/>{coupled(patella_j, ' damping="1" armature="0.005"')}
          <geom name="{patella_geom}" type="sphere" size="0.02" contype="0" conaffinity="0"/>
        </body>"""
  equalities = "\n    ".join(
      f'<joint joint1="{n}" joint2="knee_angle_{side}" polycoef="{_f(*c)}"/>'
      for n, *_, c in patella_j + tibia_j)
  return knee, patella, equalities


def _joint_xml(name, kind, axis, rng, extra="") -> str:
  return (f'<joint name="{name}" type="{kind}" axis="{_f(*axis)}" '
          f'range="{_f(*rng)}"{extra}/>')


# muscle templates: name, force (N), then the path as (body, site pos)
# points and ("wrap", geom, sidesite or "") entries. Bodies are named
# without the side suffix; y coordinates are for the left leg and mirror
# for the right. The first eight cover the hip's sphere wrap, the knee's
# cylinder wrap, both with a side site, and every joint group.
_LEG_MUSCLES = (
    ("iliacus", 900, (("pelvis", (0.07, 0.065, 0.0)),
                      ("wrap", "hip_wrap", "hip_front"),
                      ("femur", (0.035, -0.005, -0.09)))),
    ("recfem", 1200, (("pelvis", (0.06, 0.075, -0.04)),
                      ("femur", (0.05, 0.0, -0.36)),
                      ("wrap", "knee_wrap", "knee_front"),
                      ("tibia", (0.045, 0.0, -0.07)))),
    ("glmax", 1400, (("pelvis", (-0.09, 0.06, 0.02)),
                     ("wrap", "hip_wrap", ""),
                     ("femur", (-0.035, 0.01, -0.12)))),
    ("bflh", 900, (("pelvis", (-0.07, 0.07, -0.09)),
                   ("femur", (-0.05, 0.0, -0.33)),
                   ("wrap", "knee_wrap", "knee_back"),
                   ("tibia", (-0.035, 0.01, -0.07)))),
    ("vasint", 1800, (("femur", (0.045, 0.0, -0.18)),
                      ("wrap", "knee_wrap", "knee_front"),
                      ("tibia", (0.045, 0.0, -0.06)))),
    ("soleus", 2200, (("tibia", (-0.035, 0.0, -0.15)),
                      ("calcn", (-0.06, 0.0, 0.01)))),
    ("tibant", 800, (("tibia", (0.035, 0.0, -0.12)),
                     ("tibia", (0.04, 0.0, -0.36)),
                     ("calcn", (0.08, -0.005, 0.0)))),
    ("fdl", 400, (("tibia", (-0.02, -0.01, -0.25)),
                  ("calcn", (0.0, -0.015, -0.01)),
                  ("toes", (0.03, 0.0, -0.02)))),
    ("glmed", 1100, (("pelvis", (0.0, 0.14, 0.05)),
                     ("femur", (0.0, 0.045, -0.06)))),
    ("addlong", 700, (("pelvis", (0.03, 0.02, -0.09)),
                      ("femur", (0.01, -0.02, -0.2)))),
    ("gastroc", 1300, (("femur", (-0.035, 0.0, -0.39)),
                       ("wrap", "knee_wrap", "knee_back"),
                       ("calcn", (-0.06, 0.0, 0.015)))),
    ("perlong", 600, (("tibia", (0.0, 0.03, -0.2)),
                      ("tibia", (-0.01, 0.03, -0.38)),
                      ("calcn", (0.05, 0.03, -0.02)))),
    ("tibpost", 800, (("tibia", (-0.01, -0.02, -0.2)),
                      ("tibia", (-0.015, -0.02, -0.38)),
                      ("calcn", (0.04, -0.03, -0.02)))),
    ("piri", 500, (("pelvis", (-0.06, 0.04, -0.03)),
                   ("femur", (-0.01, 0.05, -0.02)))),
    ("sart", 400, (("pelvis", (0.08, 0.11, -0.02)),
                   ("femur", (0.0, -0.04, -0.38)),
                   ("tibia", (0.01, -0.035, -0.08)))),
    ("edl", 400, (("tibia", (0.03, 0.01, -0.2)),
                  ("calcn", (0.08, 0.0, 0.01)),
                  ("toes", (0.03, 0.0, 0.01)))),
)


# MyoLeg's 40 muscle names per side (what the reflex controller looks up
# as ``<name>_<r|l>``), each with the ``_LEG_MUSCLES`` template whose path
# does its job: adductors on addlong's, hamstrings and bfsh on bflh's, the
# abductors and tfl on glmed's, and so on
REFLEX_MUSCLES = (
    ("addbrev", "addlong"), ("addlong", "addlong"),
    ("addmagDist", "addlong"), ("addmagIsch", "addlong"),
    ("addmagMid", "addlong"), ("addmagProx", "addlong"), ("bflh", "bflh"),
    ("bfsh", "bflh"), ("edl", "edl"), ("ehl", "edl"), ("fdl", "fdl"),
    ("fhl", "fdl"), ("gaslat", "gastroc"), ("gasmed", "gastroc"),
    ("glmax1", "glmax"), ("glmax2", "glmax"), ("glmax3", "glmax"),
    ("glmed1", "glmed"), ("glmed2", "glmed"), ("glmed3", "glmed"),
    ("glmin1", "glmed"), ("glmin2", "glmed"), ("glmin3", "glmed"),
    ("grac", "addlong"), ("iliacus", "iliacus"), ("perbrev", "perlong"),
    ("perlong", "perlong"), ("piri", "piri"), ("psoas", "iliacus"),
    ("recfem", "recfem"), ("sart", "sart"), ("semimem", "bflh"),
    ("semiten", "bflh"), ("soleus", "soleus"), ("tfl", "glmed"),
    ("tibant", "tibant"), ("tibpost", "tibpost"), ("vasint", "vasint"),
    ("vaslat", "vasint"), ("vasmed", "vasint"),
)


def _muscle_templates(count: int, names: tuple | None):
  """(muscle name without side, template, k) per muscle: the k-th use of
  a template. Without ``names``, the templates in turn, named
  ``<template><k + 1>``; with ``names`` ((name, template) pairs), those."""
  by_name = {t[0]: t for t in _LEG_MUSCLES}
  if names is None:
    n = len(_LEG_MUSCLES)
    return [(f"{_LEG_MUSCLES[i % n][0]}{i // n + 1}", _LEG_MUSCLES[i % n],
             i // n) for i in range(count)]
  uses: dict[str, int] = {}
  out = []
  for name, template in names:
    k = uses.get(template, 0)
    uses[template] = k + 1
    out.append((name, by_name[template], k))
  return out


def _leg_muscles(side: str, count: int,
                 names: tuple | None = None) -> tuple[dict, str, str]:
  """``count`` muscles of one leg from the templates (or the muscles of
  ``names``, see ``_muscle_templates``): their sites per body (name ->
  MJCF), the spatial tendons and the actuators. The k-th use of a
  template shifts every site by a few millimetres so that no two muscles
  share a path."""
  mirror = 1.0 if side == "l" else -1.0
  sites: dict[str, list[str]] = {}
  tendons, actuators = [], []
  for base, (_, force, path), k in _muscle_templates(count, names):
    mname = f"{base}_{side}"
    shift = (0.004 * k, 0.003 * k * (-1) ** k, -0.005 * k)
    parts = []
    for j, point in enumerate(path):
      if point[0] == "wrap":
        side_site = f' sidesite="{point[2]}_{side}"' if point[2] else ""
        parts.append(f'<geom geom="{point[1]}_{side}"{side_site}/>')
        continue
      body, (x, y, z) = point
      sname = f"{mname}_p{j}"
      pos = (x + shift[0], mirror * (y + shift[1]), z + shift[2])
      sites.setdefault(body, []).append(
          f'<site name="{sname}" pos="{_f(*pos)}"/>')
      parts.append(f'<site site="{sname}"/>')
    tendons.append(f'<spatial name="{mname}_t">{"".join(parts)}</spatial>')
    actuators.append(_muscle(mname, force * (0.9 + 0.05 * k)))
  return ({b: "".join(s) for b, s in sites.items()},
          "\n    ".join(tendons), "\n    ".join(actuators))


def _leg(side: str, sites: dict, knee: str = "", patella: str = "",
         btm: bool = False) -> str:
  """One leg from the hip down (femur, tibia, talus, calcn, toes).
  ``knee`` replaces the tibia's two knee joints, ``patella`` adds MJCF
  in the femur after its sites, ``btm`` adds ``<s>_heel_btm`` and
  ``<s>_toe_btm`` sites under the heel and the toe tip."""
  m = 1.0 if side == "l" else -1.0
  s = side
  foot = f'contype="{_FOOT_BITS}" conaffinity="{_GROUND_BITS}"'
  vis = 'contype="0" conaffinity="0"'
  hip = (_LEG_HIP[0], m * _LEG_HIP[1], _LEG_HIP[2])
  knee = knee or f"""
          <joint name="knee_angle_{s}" axis="0 1 0" range="0 2.0" damping="4" stiffness="300" armature="0.01"/>
          <joint name="knee_angle_translation_{s}" type="slide" axis="1 0 0" range="-0.03 0.03" damping="20" armature="0.02"/>"""
  heel_btm = (f'\n              <site name="{s}_heel_btm" pos="-0.05 0 -0.05"/>'
              if btm else "")
  toe_btm = (f'\n                <site name="{s}_toe_btm" pos="0.045 0 -0.03"/>'
             if btm else "")
  return f"""
      <body name="femur_{s}" pos="{_f(*hip)}">
        <inertial pos="0 0 -0.18" mass="8.5" diaginertia="0.14 0.14 0.025"/>
        <joint name="hip_flexion_{s}" axis="0 -1 0" range="-0.5 1.6" damping="4" stiffness="300" armature="0.01"/>
        <joint name="hip_adduction_{s}" axis="{_f(-m, 0, 0)}" range="-0.5 0.5" damping="4" stiffness="300" armature="0.01"/>
        <joint name="hip_rotation_{s}" axis="{_f(0, 0, m)}" range="-0.6 0.6" damping="4" stiffness="150" armature="0.01"/>
        <geom name="femur_bone_{s}" type="capsule" fromto="{_f(0, 0, 0, 0, 0, -_FEMUR_LEN)}" size="0.05" {vis}/>
        <geom name="knee_wrap_{s}" type="cylinder" pos="{_f(0, 0, -_FEMUR_LEN)}" zaxis="0 1 0" size="0.04 0.05" {vis}/>
        <site name="knee_front_{s}" pos="{_f(0.08, 0, -_FEMUR_LEN)}"/>
        <site name="knee_back_{s}" pos="{_f(-0.08, 0, -_FEMUR_LEN)}"/>{sites.get("femur", "")}{patella}
        <body name="tibia_{s}" pos="{_f(0, 0, -_FEMUR_LEN)}">
          <inertial pos="0 0 -0.17" mass="3.6" diaginertia="0.05 0.05 0.006"/>{knee}
          <geom name="tibia_bone_{s}" type="capsule" fromto="{_f(0, 0, -0.03, 0, 0, -_TIBIA_LEN)}" size="0.04" {vis}/>{sites.get("tibia", "")}
          <body name="talus_{s}" pos="{_f(0, 0, -_TIBIA_LEN)}">
            <inertial pos="0 0 -0.02" mass="0.1" diaginertia="0.0002 0.0002 0.0002"/>
            <joint name="ankle_angle_{s}" axis="0 -1 0" range="-0.7 0.5" damping="2" stiffness="200" armature="0.005"/>
            <body name="calcn_{s}" pos="{_f(0, 0, -_TALUS_LEN)}">
              <inertial pos="0.05 0 -0.02" mass="1.2" diaginertia="0.004 0.004 0.001"/>
              <joint name="subtalar_angle_{s}" axis="{_f(m, 0, 0.3)}" range="-0.35 0.35" damping="2" stiffness="100" armature="0.005"/>
              <geom name="heel_{s}" type="sphere" pos="-0.05 0 -0.02" size="0.03" {foot}/>
              <geom name="sole_{s}" type="capsule" fromto="-0.03 0 -0.025 0.12 0 -0.025" size="0.025" {foot}/>
              <site name="{s[0]}_foot" pos="0.03 0 -0.04" size="0.09 0.05 0.03" type="box"/>{heel_btm}{sites.get("calcn", "")}
              <body name="toes_{s}" pos="0.15 0 -0.02">
                <inertial pos="0.02 0 -0.01" mass="0.2" diaginertia="0.0003 0.0003 0.0003"/>
                <joint name="mtp_angle_{s}" axis="0 -1 0" range="-0.5 0.9" damping="0.5" stiffness="30" armature="0.002"/>
                <geom name="toe_bar_{s}" type="capsule" fromto="{_f(0.005, -0.03, -0.01, 0.005, 0.03, -0.01)}" size="0.02" {foot}/>
                <geom name="toe_tip_{s}" type="sphere" pos="0.045 0 -0.015" size="0.015" {foot}/>
                <site name="{s[0]}_toes" pos="0.03 0 -0.025" size="0.04 0.05 0.02" type="box"/>{toe_btm}{sites.get("toes", "")}
              </body>
            </body>
          </body>
        </body>
      </body>"""


def _couple(q: float, coef) -> float:
  return sum(c * q ** i for i, c in enumerate(coef))


def _leg_key(hip=(0.0, 0.0), knee=(0.0, 0.0), ankle=(0.0, 0.0),
             drop: float = 0.0, myoleg_knee: bool = False) -> list[float]:
  """A keyframe's qpos: the pelvis ``drop`` m under the standing height,
  facing +y; hip flexion, knee and ankle angles per side (left, right);
  each knee's coupled joints on their curves (the one slide, or with
  ``myoleg_knee`` MyoLeg's seven, in qpos order)."""
  qpos = [0.0, 0.0, _PELVIS_HEIGHT - drop, 0.70710678, 0.0, 0.0, 0.70710678]
  for i in range(2):
    if myoleg_knee:
      beta = [_couple(knee[i], c) for *_, c in _KNEE_PATELLA]
      t2, t1, r2, r3 = (_couple(knee[i], c) for *_, c in _KNEE_TIBIA)
      qpos += [hip[i], 0.0, 0.0, *beta, t2, t1, knee[i], r2, r3, ankle[i],
               0.0, 0.0]
    else:
      qpos += [hip[i], 0.0, 0.0, knee[i], _couple(knee[i], KNEE_POLYCOEF),
               ankle[i], 0.0, 0.0]
  return qpos


# standing; a slight crouch; and two mid-stride poses (left leg forward,
# then right), whose pelvis drop keeps the stance foot on the ground
_LEG_POSES = (
    dict(),
    dict(hip=(0.15, 0.15), knee=(0.3, 0.3), ankle=(0.15, 0.15), drop=0.0087),
    dict(hip=(0.3, -0.2), knee=(0.15, 0.05), ankle=(0.05, 0.15), drop=0.0016),
    dict(hip=(-0.2, 0.3), knee=(0.05, 0.15), ankle=(0.15, 0.05), drop=0.0016),
)


def legs_fixture_xml(muscles_per_leg: int = 40, chasetag: bool = False,
                     reflex: bool = False, myoleg_knee: bool = False) -> str:
  """MJCF text of the synthetic two-leg scene, MyoLeg's names and width.

  - ``pelvis`` on a free joint (a ``pelvis`` site at its origin) with the
    ``torso`` welded on top: 41.5 kg of the 68 kg above the hips, so the
    standing centre of mass sits at about 0.94 m;
  - per side (``_l``, ``_r``): ``femur``, ``tibia``, ``talus``, ``calcn``
    and ``toes``; joints ``hip_flexion``, ``hip_adduction``,
    ``hip_rotation``, ``knee_angle``, the slide
    ``knee_angle_translation`` coupled to the knee angle by a joint
    equality (``KNEE_POLYCOEF``), ``ankle_angle``, ``subtalar_angle`` and
    ``mtp_angle``: nv 22. The hinges carry springs about the standing
    pose, so the unactuated body stands;
  - ``muscles_per_leg`` muscles per side on spatial tendons, with a
    sphere wrap at the hip and a cylinder wrap at the knee (side sites in
    front and behind): 40 gives legs80, MyoLeg's 80 actuators; 8 gives
    legs16 for the CPU tests;
  - feet of two spheres and two capsules each, the only colliding geoms,
    against a floor plane and the hfield geom ``terrain`` (100 x 100 cells,
    flat until a task overlays it); touch sensors ``r_foot``, ``r_toes``,
    ``l_foot`` and ``l_toes`` on sites of those names;
  - keyframes: standing, a slight crouch, and two mid-stride poses (keys 2
    and 3, the walk's random reset);
  - ``chasetag``: one mocap body ``opponent`` that collides with nothing;
  - ``reflex`` (legs80_reflex): the 40 muscles per side take MyoLeg's
    names (``REFLEX_MUSCLES``, on the templates' paths), so the reflex
    controller (``agents/reflex.py``) finds its muscle groups;
  - ``myoleg_knee`` (legs80_knee, legs16_knee): each knee is MyoLeg's,
    seven joints coupled to ``knee_angle_<s>`` by joint equalities in
    place of the one slide (``_coupled_knee``, osl54's left knee on both
    legs): ``knee_angle_<s>_translation1/2`` and ``_rotation2/3`` on the
    tibia, the three ``_beta_`` joints on a ``patella_<s>`` body; nq 35,
    nv 34, 14 equalities.
  """
  names = REFLEX_MUSCLES if reflex else None
  if reflex:
    muscles_per_leg = len(REFLEX_MUSCLES)
  if muscles_per_leg < 1:
    raise ValueError(f"muscles_per_leg must be positive, got "
                     f"{muscles_per_leg}")
  legs, tendons, actuators = [], [], []
  for side in ("l", "r"):
    sites, ten, act = _leg_muscles(side, muscles_per_leg, names)
    knee, patella, _ = (_coupled_knee(side, f"patella_bone_{side}")
                        if myoleg_knee else ("", "", ""))
    legs.append(_leg(side, sites, knee=knee, patella=patella))
    tendons.append(ten)
    actuators.append(act)
  pelvis_sites = "".join(
      _leg_muscles(s, muscles_per_leg, names)[0].get("pelvis", "")
      for s in "lr")
  hip_parts = "".join(
      f"""
      <geom name="hip_wrap_{s}" type="sphere" pos="{_f(_LEG_HIP[0], m * _LEG_HIP[1], _LEG_HIP[2])}" size="0.035" contype="0" conaffinity="0"/>
      <site name="hip_front_{s}" pos="{_f(0.07, m * _LEG_HIP[1], _LEG_HIP[2])}"/>"""
      for s, m in (("l", 1.0), ("r", -1.0)))
  nrow, ncol, size = _HFIELD
  keys = "\n    ".join(
      f'<key qpos="{_f(*_leg_key(**pose, myoleg_knee=myoleg_knee))}"/>'
      for pose in _LEG_POSES)
  opponent = ("""
    <body name="opponent" mocap="true" pos="2 2 0.9">
      <geom name="opponent_body" type="capsule" fromto="0 0 -0.5 0 0 0.5" size="0.15" contype="0" conaffinity="0"/>
    </body>""" if chasetag else "")
  equalities = "\n    ".join(
      _coupled_knee(s, "")[2] if myoleg_knee else
      f'<joint joint1="knee_angle_translation_{s}" joint2="knee_angle_{s}" '
      f'polycoef="{_f(*KNEE_POLYCOEF)}"/>' for s in "lr")
  name = (f"legs{2 * muscles_per_leg}" + ("_chasetag" if chasetag else "")
          + ("_reflex" if reflex else "") + ("_knee" if myoleg_knee else ""))
  return f"""<mujoco model="{name}">
  <compiler angle="radian" autolimits="true"/>
  <option timestep="0.002" iterations="100" ls_iterations="50"/>
  <asset>
    <hfield name="terrain" nrow="{nrow}" ncol="{ncol}" size="{_f(*size)}"/>
  </asset>
  <worldbody>
    <geom name="floor" type="plane" size="10 10 0.1" contype="{_GROUND_BITS}" conaffinity="{_GROUND_BITS | _FOOT_BITS}"/>
    <geom name="terrain" type="hfield" hfield="terrain" pos="{_f(*_TERRAIN_POS)}" euler="0 0 3.14159265" contype="{_GROUND_BITS}" conaffinity="{_GROUND_BITS | _FOOT_BITS}"/>
    <body name="pelvis" pos="{_f(0, 0, _PELVIS_HEIGHT)}" quat="0.70710678 0 0 0.70710678">
      <freejoint name="root"/>
      <inertial pos="0 0 0" mass="11.5" diaginertia="0.1 0.09 0.08"/>
      <geom name="pelvis_bone" type="capsule" fromto="0 -0.1 0 0 0.1 0" size="0.07" contype="0" conaffinity="0"/>
      <site name="pelvis"/>{hip_parts}{pelvis_sites}
      <body name="torso" pos="0 0 0.1">
        <inertial pos="0 0 0.24" mass="30" diaginertia="1.3 1.2 0.3"/>
        <geom name="torso_bone" type="capsule" fromto="0 0 0.05 0 0 0.45" size="0.13" contype="0" conaffinity="0"/>
      </body>{"".join(legs)}
    </body>{opponent}
  </worldbody>
  <equality>
    {equalities}
  </equality>
  <tendon>
    {chr(10).join("    " + t for t in tendons).strip()}
  </tendon>
  <actuator>
    {chr(10).join("    " + a for a in actuators).strip()}
  </actuator>
  <sensor>
    <touch name="r_foot" site="r_foot"/>
    <touch name="r_toes" site="r_toes"/>
    <touch name="l_foot" site="l_foot"/>
    <touch name="l_toes" site="l_toes"/>
  </sensor>
  <keyframe>
    {keys}
  </keyframe>
</mujoco>
"""


def plate_fixture_xml() -> str:
  """A ball resting on a hinged plate, with a ``<force>`` sensor at the
  plate's mount ("plate", nv 7): the scene of the JAX package's sensor
  tests, for the static-weight check on the card (at rest the mount
  carries the plate's 0.5 kg and the ball's 0.2 kg)."""
  return """
<mujoco>
  <option timestep="0.002" gravity="0 0 -9.81"/>
  <worldbody>
    <body name="plate" pos="0 0 0.5">
      <joint name="tilt" type="hinge" axis="0 1 0" damping="0.5"/>
      <geom type="box" size="0.2 0.2 0.01" mass="0.5"/>
      <site name="mount" pos="0 0 0" euler="0 0 0.4"/>
    </body>
    <body name="ball" pos="0.0 0 0.56">
      <freejoint/>
      <geom type="sphere" size="0.04" mass="0.2"/>
    </body>
  </worldbody>
  <sensor>
    <force name="plate_load" site="mount"/>
  </sensor>
</mujoco>
"""


# the hull scene's slab: a rectangle below, a smaller quadrilateral turned
# against it above (8 vertices, 12 hull triangles); its four lowest
# vertices are the bottom face, so the plane-mesh pair's four contact
# points hold it flat
_SLAB_VERTS = ((-0.07, -0.05, 0.0), (0.07, -0.05, 0.0), (0.07, 0.05, 0.0),
               (-0.07, 0.05, 0.0), (-0.05, -0.055, 0.025),
               (0.055, -0.04, 0.025), (0.05, 0.055, 0.025),
               (-0.06, 0.04, 0.025))


def hulls_fixture_xml() -> str:
  """Free bodies over a plane, on an inline convex mesh ("hulls", nv 24):

  - ``slab``: a free body whose one geom is the mesh ``slab`` (see
    ``_SLAB_VERTS``), lying on the plane (the plane-mesh pair);
  - ``ball`` (a sphere), ``egg`` (an ellipsoid) and ``pill`` (a capsule),
    free bodies that drop onto the slab's top (sphere-mesh,
    ellipsoid-mesh); the capsule lands across the slab's edge and rests
    with one end on the slab (capsule-mesh) and the other on the plane.

  The three small bodies collide with the slab and the plane, not with
  each other. The round bodies and the capsule have condim 6 (rolling
  friction stops them), the slab condim 3. Every mesh pair of the
  reference runs in dynamics, as ``prims_fixture_xml`` runs the primitive
  pairs.
  """
  verts = " ".join(_f(*v) for v in _SLAB_VERTS)
  roll = 'condim="6" friction="1 0.01 0.01" contype="4" conaffinity="3"'
  return f"""<mujoco model="hulls_fixture">
  <compiler angle="radian" autolimits="true"/>
  <option timestep="0.002" iterations="100" ls_iterations="50"/>
  <asset>
    <mesh name="slab" vertex="{verts}"/>
  </asset>
  <worldbody>
    <geom name="floor" type="plane" size="0.5 0.5 0.05" contype="1" conaffinity="1"/>
    <body name="slab" pos="0 0 0.0005">
      <freejoint/>
      <geom name="slab" type="mesh" mesh="slab" density="800" contype="2" conaffinity="5"/>
    </body>
    <body name="ball" pos="0.012 0.006 0.055">
      <freejoint/>
      <geom name="ball" type="sphere" size="0.015" {roll}/>
    </body>
    <body name="egg" pos="-0.03 -0.012 0.05" euler="0 0 0.4">
      <freejoint/>
      <geom name="egg" type="ellipsoid" size="0.02 0.015 0.01" {roll}/>
    </body>
    <body name="pill" pos="0.072 0.012 0.05">
      <freejoint/>
      <geom name="pill" type="capsule" size="0.01 0.035" euler="0 1.5708 0" {roll}/>
    </body>
  </worldbody>
</mujoco>
"""


# ---------------------------------------------------------------------------
# the baoding scene: the hand palm up at qpos0 at MyoSuite's height, a
# tray on the palm and two free balls in it
# ---------------------------------------------------------------------------

# the forearm's height: the balls rest near z = 1.29 m, above the task's
# drop threshold of 1.25 m
_BAODING_HEIGHT = 1.24
# the tray's centre in the palm's frame (palmar side is -z), its half
# width, and the balls' radius, mass and start offset from the centre
_TRAY = (0.045, -0.01)
_TRAY_HALF = 0.045
_TRAY_SURFACE = -0.028
_BALL = (0.0215, 0.043)
_BALL_OFFSET = 0.025
# the reference's centre of the target ellipse, in the target sites' frame
_BAODING_CENTER = (-0.0125, -0.07)
# a spring on the wrist's joints about the palm-up pose (N m / rad): the
# balls sit above the pronation axis, so a limp wrist turns them off
_WRIST_SPRING = 3.0


def baoding_fixture_xml(digits: int = 5) -> str:
  """The hand palm up at qpos0 (the forearm turned half a turn about its
  long axis, at a height of ``_BAODING_HEIGHT``) with two free balls,
  ``ball1`` and ``ball2`` (geoms and bodies of those names, sites
  ``ball1_site`` and ``ball2_site``), the last two joints: hand23 gives nv
  35, hand11 nv 23.

  A tray on the palm (a flat pad and four low rims, colliding with the
  balls only) holds them, and springs on the wrist's three joints hold
  the palm up (``_WRIST_SPRING``); the balls collide with each other, the digits,
  the tray and the floor. ``target1_site`` and ``target2_site`` sit on a
  massless body welded to the palm, ``baoding_frame``, placed so that the
  reference's ellipse centre (-0.0125, -0.07) in that frame is the tray's
  centre; their z in that frame is the resting balls' height.
  """
  cx, cy = _BAODING_CENTER
  tx, ty = _TRAY
  h, r, z = _TRAY_HALF, 0.006, _TRAY_SURFACE
  pad = f'contype="{_PALM_BIT}" conaffinity="0"'
  rims = "".join(
      f"""
          <geom name="tray_rim{i}" type="capsule" fromto="{_f(*a, z - r, *b, z - r)}" size="{r:g}" {pad}/>"""
      for i, (a, b) in enumerate((
          ((tx - h, ty - h), (tx + h, ty - h)),
          ((tx - h, ty + h), (tx + h, ty + h)),
          ((tx - h, ty - h), (tx - h, ty + h)),
          ((tx + h, ty - h), (tx + h, ty + h)))))
  target_z = z - _BALL[0]
  palm = f"""
          <geom name="tray" type="box" pos="{_f(tx, ty, z + 0.004)}" size="{_f(h, h, 0.004)}" {pad}/>{rims}
          <body name="baoding_frame" pos="{_f(tx - cx, ty - cy, 0)}">
            <site name="target1_site" pos="{_f(cx + 0.025, cy, target_z)}" size="0.005"/>
            <site name="target2_site" pos="{_f(cx - 0.025, cy, target_z)}" size="0.005"/>
          </body>"""
  body, tendons, actuators = _forearm_body(
      digits, f'pos="0 0 {_BAODING_HEIGHT:g}" euler="3.14159265 0 0"',
      'axis="1 0 0" range="-1.0 1.0"', palm,
      wrist_spring=f'stiffness="{_WRIST_SPRING:g}"')
  ball_bits = (f'contype="{_OBJECT_BIT}" '
               f'conaffinity="{1 | _DIGIT_BITS | _PALM_BIT | _OBJECT_BIT}"')
  balls = ""
  for i, dy in ((1, _BALL_OFFSET), (2, -_BALL_OFFSET)):
    # the palm's frame to the world's at qpos0: (0.12 + x, -y, H - z)
    pos = (0.12 + tx, -(ty + dy), _BAODING_HEIGHT - (z - _BALL[0] - 0.003))
    balls += f"""
    <body name="ball{i}" pos="{_f(*pos)}">
      <freejoint name="ball{i}_free"/>
      <geom name="ball{i}" type="sphere" size="{_BALL[0]:g}" mass="{_BALL[1]:g}" {ball_bits}/>
      <site name="ball{i}_site" size="0.005"/>
    </body>"""
  return _scene(f"baoding_fixture_{digits}", body + balls, tendons, actuators)


# ---------------------------------------------------------------------------
# the SAR scene: the object scenes' hand, moved so that its palm-up pad
# lies over world x = 0, and a free object carrying one geom of each
# candidate type
# ---------------------------------------------------------------------------

# the forearm's position; at pro_sup = -1.5 the pad's top lies near
# (0.0, 0.010, 0.115)
_SAR_FOREARM = (-0.16, 0.0, _TURNED_HEIGHT)
# the object's start: over the pad, clear of the largest table size
_SAR_START = (0.0, 0.005, 0.148)


def sar_fixture_xml(digits: int = 5, condim: int = 4) -> str:
  """The SAR reorientation scene on the hand of the object scenes (thumb
  up, pronation reversed, a palm pad), moved so that the pad lies over
  world x = 0: the task zeroes ``qpos[:-6]`` at init, which holds the
  object's x as well (the reference's quirk), so the object starts at
  x = 0. hand23: nv 29; hand11: nv 17.

  - ``Object``: a free body lying along world x with the four candidate
    geoms ``obj_caps``, ``obj_ellip``, ``obj_cyl`` and ``obj_box`` at its
    centre, each of condim ``condim`` (4 for Geometries8/100, 3 for the
    in- and out-of-distribution tasks), with the densities of the JAX
    package's SAR scene (1500, then 1); the task's overlay sizes the
    active one and shrinks the others to a point inside it;
  - ``eps_ball``: the desired position, the object's start;
  - ``target``: a static body 20 cm above with a non-colliding geom.
  """
  obj_bits = (f'condim="{condim}" contype="{_OBJECT_BIT}" '
              f'conaffinity="{1 | _DIGIT_BITS | _PALM_BIT}"')
  start = _f(*_SAR_START)
  above = _f(_SAR_START[0], _SAR_START[1], _SAR_START[2] + 0.2)
  obj = f"""
    <site name="eps_ball" pos="{start}" size="0.075"/>
    <body name="target" pos="{above}" euler="0 1.5708 0">
      <geom name="target" type="ellipsoid" size="0.015 0.015 0.045" contype="0" conaffinity="0"/>
    </body>
    <body name="Object" pos="{start}" euler="0 1.5708 0">
      <freejoint name="object_free"/>
      <geom name="obj_caps" type="capsule" size="0.015 0.035" density="1500" {obj_bits}/>
      <geom name="obj_ellip" type="ellipsoid" size="0.015 0.015 0.045" density="1" {obj_bits}/>
      <geom name="obj_cyl" type="cylinder" size="0.015 0.035" density="1" {obj_bits}/>
      <geom name="obj_box" type="box" size="0.017 0.017 0.017" density="1" {obj_bits}/>
    </body>"""
  palm_pad = f"""
          <geom name="palm_pad" type="capsule" fromto="0.012 -0.01 -0.006 0.062 -0.01 -0.006" size="0.02" contype="{_PALM_BIT}" conaffinity="0"/>"""
  body, tendons, actuators = _forearm_body(
      digits, f'pos="{_f(*_SAR_FOREARM)}" euler="1.5708 0 0"',
      'axis="-1 0 0" range="-1.6 1.0"', palm_pad)
  return _scene(f"sar_fixture_{digits}_condim{condim}", body + obj, tendons,
                actuators)


# ---------------------------------------------------------------------------
# the arm: the hand under three shoulder hinges and an elbow, with 24
# muscles over the shoulder and the elbow (MyoArm's width)
#
# At qpos0 the upper arm hangs from the shoulder and the forearm points
# forward (world -y), palm down. Frames: ``thorax`` (static) and
# ``humerus`` are world-aligned at the shoulder; the forearm's x is world
# -y, its y world +x, its z world +z (its origin is the elbow).
# ---------------------------------------------------------------------------

_HUMERUS_LEN = 0.30
# muscle templates: name, force (N), then the path as (body, site pos)
# points and ("wrap", geom, sidesite or "") entries
_ARM_MUSCLES = (
    ("DELT1", 500, (("thorax", (0.01, -0.035, 0.035)),
                    ("wrap", "shoulder_wrap", "shoulder_front"),
                    ("humerus", (0.005, -0.018, -0.13)))),
    ("DELT2", 600, (("thorax", (0.04, 0.0, 0.035)),
                    ("humerus", (0.02, 0.0, -0.12)))),
    ("DELT3", 400, (("thorax", (0.01, 0.035, 0.035)),
                    ("humerus", (0.005, 0.018, -0.13)))),
    ("SUPSP", 300, (("thorax", (-0.03, 0.02, 0.05)),
                    ("wrap", "shoulder_wrap", ""),
                    ("humerus", (0.01, 0.005, 0.02)))),
    ("INFSP", 500, (("thorax", (-0.05, 0.06, 0.0)),
                    ("humerus", (0.01, 0.02, -0.01)))),
    ("SUBSC", 600, (("thorax", (-0.05, -0.03, 0.0)),
                    ("humerus", (-0.01, -0.02, -0.01)))),
    ("TMIN", 200, (("thorax", (-0.03, 0.06, -0.05)),
                   ("humerus", (0.012, 0.02, -0.03)))),
    ("TMAJ", 400, (("thorax", (-0.06, 0.07, -0.1)),
                   ("humerus", (-0.01, 0.01, -0.06)))),
    ("PECM1", 500, (("thorax", (-0.1, -0.06, 0.0)),
                    ("humerus", (0.0, -0.015, -0.05)))),
    ("PECM2", 500, (("thorax", (-0.12, -0.07, -0.06)),
                    ("humerus", (0.0, -0.015, -0.06)))),
    ("PECM3", 400, (("thorax", (-0.1, -0.06, -0.12)),
                    ("humerus", (0.0, -0.015, -0.07)))),
    ("LAT1", 500, (("thorax", (-0.1, 0.08, -0.1)),
                   ("humerus", (-0.01, 0.0, -0.05)))),
    ("LAT2", 500, (("thorax", (-0.1, 0.08, -0.2)),
                   ("humerus", (-0.01, 0.0, -0.055)))),
    ("LAT3", 400, (("thorax", (-0.08, 0.07, -0.3)),
                   ("humerus", (-0.01, 0.0, -0.06)))),
    ("CORB", 200, (("thorax", (-0.02, -0.04, -0.01)),
                   ("humerus", (-0.005, -0.01, -0.15)))),
    ("BIClong", 600, (("thorax", (0.0, -0.03, 0.03)),
                      ("humerus", (0.0, -0.025, -0.15)),
                      ("forearm", (0.045, 0.0, 0.012)))),
    ("BICshort", 500, (("thorax", (-0.02, -0.04, -0.01)),
                       ("humerus", (-0.005, -0.025, -0.16)),
                       ("forearm", (0.05, 0.004, 0.012)))),
    ("TRIlong", 700, (("thorax", (-0.02, 0.03, -0.03)),
                      ("humerus", (0.0, 0.025, -0.2)),
                      ("wrap", "elbow_wrap", "elbow_back"),
                      ("forearm", (-0.02, 0.0, 0.005)))),
    ("TRIlat", 600, (("humerus", (0.01, 0.02, -0.08)),
                     ("wrap", "elbow_wrap", "elbow_back"),
                     ("forearm", (-0.02, 0.005, 0.0)))),
    ("TRImed", 600, (("humerus", (-0.01, 0.02, -0.12)),
                     ("wrap", "elbow_wrap", "elbow_back"),
                     ("forearm", (-0.02, -0.005, 0.0)))),
    ("BRA", 800, (("humerus", (0.0, -0.02, -0.18)),
                  ("forearm", (0.03, 0.0, 0.01)))),
    ("BRA2", 300, (("humerus", (0.0, -0.02, -0.25)),
                   ("forearm", (0.06, 0.0, 0.01)))),
    ("BRD", 300, (("humerus", (0.015, -0.015, -0.22)),
                  ("forearm", (0.1, 0.01, 0.005)))),
    ("ANC", 150, (("humerus", (0.01, 0.015, -0.29)),
                  ("forearm", (0.02, 0.012, -0.003)))),
)


def _arm_muscles() -> tuple[dict, str, str]:
  """The arm's muscle sites per body (name -> MJCF), its spatial tendons
  and its muscles."""
  sites: dict[str, list[str]] = {}
  tendons, actuators = [], []
  for name, force, path in _ARM_MUSCLES:
    parts = []
    for j, point in enumerate(path):
      if point[0] == "wrap":
        side = f' sidesite="{point[2]}"' if point[2] else ""
        parts.append(f'<geom geom="{point[1]}"{side}/>')
        continue
      sname = f"{name}_p{j}"
      sites.setdefault(point[0], []).append(
          f'\n      <site name="{sname}" pos="{_f(*point[1])}"/>')
      parts.append(f'<site site="{sname}"/>')
    tendons.append(f'\n    <spatial name="{name}_t">{"".join(parts)}</spatial>')
    actuators.append(_muscle(name, force))
  return ({b: "".join(s) for b, s in sites.items()}, "".join(tendons),
          "\n    ".join(actuators))


def _arm(digits: int, shoulder: tuple, palm: str = "",
         nails: bool = False) -> tuple[str, str, str]:
  """The arm from the thorax down (bodies ``thorax``, ``humerus``,
  ``forearm``, then the hand), its tendons and muscles: the 24 arm
  muscles first, then the hand's. Joints ``elv_angle``, ``shoulder_elv``,
  ``shoulder_rot`` (springs about qpos0 hold the pose the unactuated arm
  starts in) and ``elbow_flexion`` (positive lifts the forearm)."""
  sites, arm_tendons, arm_muscles = _arm_muscles()
  elbow = f"""
      <joint name="elbow_flexion" axis="0 -1 0" range="-0.6 1.8" damping="0.5" stiffness="15" armature="0.005"/>{sites["forearm"]}"""
  hand, tendons, actuators = _forearm_body(
      digits, f'pos="0 0 {-_HUMERUS_LEN:g}" euler="0 0 -1.5708"',
      'axis="1 0 0" range="-1.0 1.0"', palm, inner=elbow, nails=nails)
  body = f"""
    <body name="thorax" pos="{_f(*shoulder)}">
      <geom name="thorax_bone" type="capsule" fromto="-0.15 0.03 0 -0.15 0.03 -0.4" size="0.08" contype="0" conaffinity="0"/>
      <geom name="shoulder_wrap" type="sphere" size="0.025" contype="0" conaffinity="0"/>
      <site name="shoulder_front" pos="0 -0.045 0"/>{sites["thorax"]}
    </body>
    <body name="humerus" pos="{_f(*shoulder)}">
      <inertial pos="0 0 -0.15" mass="1.8" diaginertia="0.012 0.012 0.002"/>
      <joint name="elv_angle" axis="0 1 0" range="-1.0 1.0" damping="1" stiffness="30" armature="0.01"/>
      <joint name="shoulder_elv" axis="-1 0 0" range="-0.8 2.0" damping="1" stiffness="30" armature="0.01"/>
      <joint name="shoulder_rot" axis="0 0 1" range="-1.0 1.0" damping="1" stiffness="30" armature="0.01"/>
      <geom name="humerus_bone" type="capsule" fromto="0 0 0 0 0 {-_HUMERUS_LEN:g}" size="0.022" contype="0" conaffinity="0"/>
      <geom name="elbow_wrap" type="cylinder" pos="0 0 {-_HUMERUS_LEN:g}" zaxis="1 0 0" size="0.02 0.03" contype="0" conaffinity="0"/>
      <site name="elbow_front" pos="0 -0.04 {-_HUMERUS_LEN:g}"/>
      <site name="elbow_back" pos="0 0.04 {-_HUMERUS_LEN:g}"/>{sites["humerus"]}{hand.replace(chr(10), chr(10) + "  ")}
    </body>"""
  return body, arm_tendons + tendons, arm_muscles + "\n    " + actuators


def arm_fixture_xml(digits: int = 5) -> str:
  """The arm alone over the floor, shoulder at ``_RELOCATE_SHOULDER``:
  digits 5 gives arm27 (nv 27, 63 muscles: hand23's 39 and 24 over the
  shoulder and the elbow), digits 2 arm15 (nv 15, 45 muscles)."""
  body, tendons, actuators = _arm(digits, _RELOCATE_SHOULDER)
  return _scene(f"arm_fixture_{digits}", body, tendons, actuators)


# ---------------------------------------------------------------------------
# relocate: the arm over a table, a free object whose collision geom is a
# convex mesh, MyoSuite's heights (the object spawns at z 1.0)
# ---------------------------------------------------------------------------

_RELOCATE_SHOULDER = (0.0, 0.05, 1.42)
_TABLE_HEIGHT = 0.9695
# the object: a square antiprism, 6 cm tall (8 vertices, 12 hull
# triangles); its four lowest vertices are the bottom face
_RELOCATE_OBJECT = ((0.025, 0.025, -0.03), (-0.025, 0.025, -0.03),
                    (-0.025, -0.025, -0.03), (0.025, -0.025, -0.03),
                    (0.03, 0.0, 0.03), (0.0, 0.03, 0.03), (-0.03, 0.0, 0.03),
                    (0.0, -0.03, 0.03))
_RELOCATE_START = (0.0, -0.25, 1.0)
# the grasp site under the palm (palm frame)
_S_GRASP = '\n          <site name="S_grasp" pos="0.04 -0.008 -0.03" size="0.01"/>'


def relocate_fixture_xml(digits: int = 5) -> str:
  """The relocate scene: the arm (``arm_fixture_xml``) with ellipsoid
  nails on its distal phalanges, over a table plane at z 0.9695; ``Object``,
  a free body (the last joint) whose one geom is an inline convex mesh
  resting on the table at (0, -0.25, 1.0), so that the plane-mesh,
  capsule-mesh (the digits) and ellipsoid-mesh (the nails) pairs are on
  the task's path. Sites ``S_grasp`` (under the palm), ``object_o`` (the
  object's origin) and, on a static ``target`` body, ``target_o``. Two
  keyframes: key 0, and key 1 (the elbow a little flexed, the object
  moved), which the task takes when it randomizes the object's start.
  arm27: nv 33; arm15: nv 21.
  """
  body, tendons, actuators = _arm(digits, _RELOCATE_SHOULDER, palm=_S_GRASP,
                                  nails=True)
  verts = " ".join(_f(*v) for v in _RELOCATE_OBJECT)
  obj_bits = (f'contype="{_OBJECT_BIT}" '
              f'conaffinity="{1 | _DIGIT_BITS | _NAIL_BIT}"')
  scene = f"""
    <geom name="table" type="plane" pos="0 0 {_TABLE_HEIGHT:g}" size="0.6 0.6 0.05" contype="1" conaffinity="1"/>{body}
    <body name="target" pos="0.1 -0.25 1.0">
      <site name="target_o" size="0.01"/>
    </body>
    <body name="Object" pos="{_f(*_RELOCATE_START)}">
      <freejoint name="object_free"/>
      <geom name="object" type="mesh" mesh="object" mass="0.1" {obj_bits}/>
      <site name="object_o" size="0.005"/>
    </body>"""
  nhand = 3 + 4 * digits
  zeros = [0.0] * (4 + nhand)
  key1 = [0.0, 0.0, 0.0, 0.1] + [0.0] * nhand
  keys = "\n    ".join(
      f'<key qpos="{_f(*q, *pos, 1, 0, 0, 0)}"/>'
      for q, pos in ((zeros, _RELOCATE_START), (key1, (0.05, -0.22, 1.0))))
  return _scene(f"relocate_fixture_{digits}", scene, tendons, actuators,
                asset=f'\n    <mesh name="object" vertex="{verts}"/>',
                extra=f"\n  <keyframe>\n    {keys}\n  </keyframe>")


# ---------------------------------------------------------------------------
# bimanual: the arm beside a prosthetic arm and hand, an object on a start
# pillar and a goal pillar, at MyoChallenge's registered centres
# ---------------------------------------------------------------------------

_MYO_SHOULDER = (-0.4, -0.05, 1.45)
_PROSTHESIS_SHOULDER = (0.4, -0.05, 1.45)
_PILLARS = {"start": (-0.4, -0.25), "goal": (0.4, -0.25)}
_PILLAR_TOP = 1.05
# the object: a capsule lying along x on the start pillar
_MANIP = (0.025, 0.04, 0.2)           # radius, half-length, mass
# the prosthesis's finger joints per digit: a thumb of three, fingers of
# two (the index, middle, ring and little in order)
_PROSTHESIS_FINGERS = (("index", 0.02), ("middle", 0.0), ("ring", -0.02),
                       ("little", -0.04))


def _prosthesis(digits: int) -> tuple[str, str]:
  """The prosthetic arm and hand under the ``prosthesis/`` prefix: three
  shoulder hinges, an elbow, two wrist hinges, a thumb of three joints and
  ``digits - 1`` fingers of two, every joint driven by a ``<position>``
  actuator over its range (centred on 0, the pose the scene starts in):
  17 joints at digits 5, 11 at 2. Its digits collide with the object
  only. Returns (body, actuators)."""
  P = "prosthesis/"
  joints: list[tuple[str, float]] = []

  def joint(name, axis, rng, kp, damping):
    joints.append((name, kp))
    return (f'\n{{pad}}<joint name="{P}{name}" axis="{axis}" '
            f'range="{_f(-rng, rng)}" damping="{damping:g}" '
            f'armature="0.005"/>')

  bits = f'contype="{_PROSTHESIS_BIT}" conaffinity="0"'

  def digit(name, pos, euler, lengths, names, depth):
    pad = " " * depth
    out = ""
    for i, (length, jn) in enumerate(zip(lengths, names)):
      p = pos if i == 0 else _f(lengths[i - 1], 0, 0)
      e = f' euler="{euler}"' if i == 0 else ""
      out += f"""
{pad}<body name="{P}{name}{i}" pos="{p}"{e}>
{pad}  <inertial pos="{_f(0.5 * length, 0, 0)}" mass="0.02" diaginertia="0.000004 0.000004 0.000001"/>{joint(jn, "0 1 0", 1.0, 2, 0.05).format(pad=pad + "  ")}
{pad}  <geom name="{P}{name}{i}" type="capsule" fromto="{_f(0, 0, 0, length, 0, 0)}" size="0.009" {bits}/>"""
      pad += "  "
    for i in reversed(range(len(lengths))):
      pad = " " * (depth + 2 * i)
      out += f"\n{pad}</body>"
    return out

  arm = "".join(joint(n, a, 1.0, kp, dmp).format(pad="      ")
                for n, a, kp, dmp in (("shoulder_elv", "-1 0 0", 80, 2),
                                      ("elv_angle", "0 1 0", 80, 2),
                                      ("shoulder_rot", "0 0 1", 80, 2)))
  elbow = joint("elbow", "0 -1 0", 1.0, 40, 1).format(pad="        ")
  wrist = "".join(joint(n, a, 1.0, 10, 0.3).format(pad="          ")
                  for n, a in (("pro_sup", "1 0 0"), ("wrist_flexion",
                                                      "0 1 0")))
  thumb = digit("thumb", "0.02 0.035 -0.01", "0 0.3 0.8",
                (0.035, 0.03, 0.025),
                ("thumb_abd", "thumb_mcp", "thumb_ip"), 12)
  fingers = "".join(
      digit(n, _f(0.08, y, 0), "0 0 0", (0.045, 0.04), (f"{n}_mcp",
                                                       f"{n}_pip"), 12)
      for n, y in _PROSTHESIS_FINGERS[:digits - 1])
  body = f"""
    <body name="{P}humerus" pos="{_f(*_PROSTHESIS_SHOULDER)}">
      <inertial pos="0 0 -0.15" mass="1.5" diaginertia="0.01 0.01 0.002"/>{arm}
      <geom name="{P}humerus" type="capsule" fromto="0 0 0 0 0 {-_HUMERUS_LEN:g}" size="0.03" contype="0" conaffinity="0"/>
      <body name="{P}forearm" pos="0 0 {-_HUMERUS_LEN:g}" euler="0 0 -1.5708">
        <inertial pos="0.1 0 0" mass="0.8" diaginertia="0.001 0.004 0.004"/>{elbow}
        <geom name="{P}forearm" type="capsule" fromto="0 0 0 0.22 0 0" size="0.025" contype="0" conaffinity="0"/>
        <body name="{P}wrist" pos="0.22 0 0">
          <inertial pos="0.02 0 0" mass="0.1" diaginertia="0.00005 0.00005 0.00005"/>{wrist}
          <body name="{P}palm" pos="0.03 0 0">
            <inertial pos="0.04 0 0" mass="0.3" diaginertia="0.0002 0.0004 0.0005"/>
            <geom name="{P}palm" type="capsule" fromto="0.01 0 0 0.07 0 0" size="0.03" {bits}/>
            <site name="{P}palm_thumb" pos="0.03 0.03 -0.02" size="0.005"/>
            <site name="{P}palm_pinky" pos="0.03 -0.04 -0.02" size="0.005"/>{thumb}{fingers}
          </body>
        </body>
      </body>
    </body>"""
  kp = {n: k for n, k in joints}
  actuators = "\n    ".join(
      f'<position name="{P}{n}" joint="{P}{n}" kp="{kp[n]:g}" '
      f'ctrlrange="-1 1"/>' for n, _ in joints)
  return body, actuators


def bimanual_fixture_xml(digits: int = 5) -> str:
  """The bimanual scene: the arm (``arm_fixture_xml``, no nails) with its
  hand over the start pillar, a prosthetic arm and hand (``_prosthesis``)
  over the goal pillar, ``manip_object`` (a free capsule, joint
  ``manip_object/freejoint``, site ``touch_site``) lying on the ``start``
  pillar, and the ``goal`` pillar, at the registered centres (-0.4, -0.25)
  and (0.4, -0.25), their tops at 1.05 m. Bodies in the order the task's
  contact classes need: the arm's, then the prosthesis's, then ``start``,
  ``goal`` and ``manip_object``. Sites ``S_grasp``, the five tips
  (``THtip`` ... ``LFtip``; with fewer than five digits the missing tips
  sit on the palm at their knuckles), ``prosthesis/palm_thumb`` and
  ``prosthesis/palm_pinky``.

  nv: the arm's 27, the prosthesis's 17 and the object's 6, 50 at digits
  5 (under the SPD kernel's 64); 15 + 11 + 6 = 32 at digits 2. MPL's own
  joint count is not in the repository; 17 joints (arm 4, wrist 2, hand
  11) is chosen to keep nv under 64. nu: 63 muscles and 17 position
  actuators (45 and 11).
  """
  missing = "".join(
      f'\n          <site name="{_TIPS[k]}" pos="{_f(0.08, _FINGERS[k - 2][0], 0)}"/>'
      for k in range(digits + 1, 6))
  arm, tendons, actuators = _arm(digits, _MYO_SHOULDER,
                                 palm=_S_GRASP + missing)
  pros, pros_actuators = _prosthesis(digits)
  h = _PILLAR_TOP / 2
  pillars = "".join(f"""
    <body name="{name}" pos="{_f(x, y, h)}">
      <geom name="{name}" type="box" size="{_f(0.04, 0.04, h)}" contype="1" conaffinity="0"/>
    </body>""" for name, (x, y) in _PILLARS.items())
  r, half, mass = _MANIP
  sx, sy = _PILLARS["start"]
  obj_bits = (f'contype="{_OBJECT_BIT}" '
              f'conaffinity="{1 | _DIGIT_BITS | _PROSTHESIS_BIT}"')
  obj = f"""
    <body name="manip_object" pos="{_f(sx, sy, _PILLAR_TOP + r + 0.0005)}">
      <freejoint name="manip_object/freejoint"/>
      <geom name="manip_object" type="capsule" size="{_f(r, half)}" euler="0 1.5708 0" mass="{mass:g}" {obj_bits}/>
      <site name="touch_site" size="0.01"/>
    </body>"""
  return _scene(f"bimanual_fixture_{digits}", arm + pros + pillars + obj,
                tendons, actuators + "\n    " + pros_actuators)


# ---------------------------------------------------------------------------
# osl54: a trans-femoral two-leg scene at the width of MyoSuite's OSL
# RunTrack model: a biological left leg, a right hip on the residual femur,
# and the OSL prosthesis (knee, ankle, foot) below it
#
# The frames follow the two-leg scene's; the keyframes face world -y, the
# run track's forward direction.
# ---------------------------------------------------------------------------

# the prosthesis's convex hulls collide with the floor plane only: the
# reference has no hfield-mesh pair, so the terrain leaves them out
_HULL_BIT = 1 << 2
# the left knee's coupled joints (MyoLeg's knee)
_OSL_PATELLA = _knee_joints(_KNEE_PATELLA, "l")
_OSL_TIBIA = _knee_joints(_KNEE_TIBIA, "l")
# every muscle of the OSL scene by its MyoSuite name (without the side) ->
# the two-leg scene's template whose path it takes; the k-th use of a
# template on a side shifts its sites, as in ``_leg_muscles``
_OSL_MUSCLE_TEMPLATE = {
    "addbrev": "addlong", "addlong": "addlong", "addmagDist": "addlong",
    "addmagIsch": "addlong", "addmagMid": "addlong", "addmagProx": "addlong",
    "grac": "addlong", "bflh": "bflh", "bfsh": "bflh", "semimem": "bflh",
    "semiten": "bflh", "edl": "edl", "ehl": "edl", "fdl": "fdl",
    "fhl": "fdl", "gaslat": "gastroc", "gasmed": "gastroc",
    "glmax1": "glmax", "glmax2": "glmax", "glmax3": "glmax",
    "glmed1": "glmed", "glmed2": "glmed", "glmed3": "glmed",
    "glmin1": "glmed", "glmin2": "glmed", "glmin3": "glmed", "tfl": "glmed",
    "iliacus": "iliacus", "psoas": "iliacus", "perbrev": "perlong",
    "perlong": "perlong", "piri": "piri", "recfem": "recfem", "sart": "sart",
    "soleus": "soleus", "tibant": "tibant", "tibpost": "tibpost",
    "vasint": "vasint", "vaslat": "vasint", "vasmed": "vasint",
}
# the prosthesis: knee and ankle motors' gears (the controller's peak
# torques, ctrl in [-1, 1]) and the hulls: hexagonal prisms along the
# joint axis, (radius, half length)
OSL_GEAR = (142.272, 168.192)
_OSL_KNEE_HULL = (0.048, 0.045)
_OSL_ANKLE_HULL = (0.04, 0.0325)
# the track: 480 rows along y over +-60 m (0.25 m per row), 10 columns
# along x over +-1 m, heights in metres (the RunTrack ids' track spans
# x in +-1 and y in [-45, 60])
_OSL_HFIELD = (480, 10, (1.0, 60.0, 1.0, 0.1))
# the keyframes' heading: facing world -y
_OSL_YAW_QUAT = (0.70710678, 0.0, 0.0, -0.70710678)
# the gait table's rows
_OSL_GAIT_ROWS = 247


def _prism_vertices(radius: float, half: float) -> str:
  """A hexagonal prism along y centred at the origin (12 vertices)."""
  ang = [i * math.pi / 3 for i in range(6)]
  verts = [(radius * math.cos(a), y, radius * math.sin(a))
           for y in (-half, half) for a in ang]
  return " ".join(_f(*v) for v in verts)


def _osl_muscles() -> tuple[dict, str, str]:
  """The 54 muscles named as MyoSuite's OSL model (``BIOLOGICAL_ACT`` of
  the run-track task), in its order: their sites per (side, body), the
  spatial tendons and the actuators."""
  from myosuite_mjx_tpu_torch.envs.run_track import BIOLOGICAL_ACT
  templates = {t[0]: t[1:] for t in _LEG_MUSCLES}
  uses: dict[tuple, int] = {}
  sites: dict[tuple, list[str]] = {}
  tendons, actuators = [], []
  for mname in BIOLOGICAL_ACT:
    base, side = mname.rsplit("_", 1)
    tname = _OSL_MUSCLE_TEMPLATE[base]
    force, path = templates[tname]
    k = uses.get((side, tname), 0)
    uses[side, tname] = k + 1
    mirror = 1.0 if side == "l" else -1.0
    shift = (0.004 * k, 0.003 * k * (-1) ** k, -0.005 * k)
    parts = []
    for j, point in enumerate(path):
      if point[0] == "wrap":
        side_site = f' sidesite="{point[2]}_{side}"' if point[2] else ""
        parts.append(f'<geom geom="{point[1]}_{side}"{side_site}/>')
        continue
      body, (x, y, z) = point
      sname = f"{mname}_p{j}"
      pos = (x + shift[0], mirror * (y + shift[1]), z + shift[2])
      sites.setdefault((side, body), []).append(
          f'<site name="{sname}" pos="{_f(*pos)}"/>')
      parts.append(f'<site site="{sname}"/>')
    tendons.append(f'<spatial name="{mname}_t">{"".join(parts)}</spatial>')
    actuators.append(_muscle(mname, force * (0.9 + 0.05 * k)))
  return ({key: "".join(s) for key, s in sites.items()},
          "\n    ".join(tendons), "\n    ".join(actuators))


def _osl_prosthesis(sites: dict) -> str:
  """The right leg: the residual femur on the hip's three joints, then the
  OSL knee, ankle and foot with its sensor sites."""
  hip = (_LEG_HIP[0], -_LEG_HIP[1], _LEG_HIP[2])
  vis = 'contype="0" conaffinity="0"'
  hull = f'contype="{_HULL_BIT}" conaffinity="0"'
  foot = f'contype="{_FOOT_BITS}" conaffinity="{_GROUND_BITS}"'
  return f"""
      <body name="femur_r" pos="{_f(*hip)}">
        <inertial pos="0 0 -0.12" mass="6.0" diaginertia="0.08 0.08 0.015"/>
        <joint name="hip_flexion_r" axis="0 -1 0" range="-0.5 1.6" damping="4" stiffness="300" armature="0.01"/>
        <joint name="hip_adduction_r" axis="1 0 0" range="-0.5 0.5" damping="4" stiffness="300" armature="0.01"/>
        <joint name="hip_rotation_r" axis="0 0 -1" range="-0.6 0.6" damping="4" stiffness="150" armature="0.01"/>
        <geom name="femur_bone_r" type="capsule" fromto="0 0 0 0 0 -0.25" size="0.05" {vis}/>
        <geom name="osl_socket" type="capsule" fromto="0 0 -0.22 0 0 -0.34" size="0.06" {vis}/>{sites.get(("r", "femur"), "")}
        <body name="osl_knee_assembly" pos="{_f(0, 0, -_FEMUR_LEN)}">
          <inertial pos="0 0 -0.12" mass="1.2" diaginertia="0.02 0.02 0.002"/>
          <joint name="osl_knee_angle_r" axis="0 1 0" range="0 2.0" damping="2" armature="0.01"/>
          <geom name="osl_knee_assembly_geom_1" type="mesh" mesh="osl_knee" {hull}/>
          <geom name="osl_pylon" type="capsule" fromto="0 0 -0.05 0 0 -0.36" size="0.015" {vis}/>
          <site name="r_socket_load" pos="0 0 0.02" euler="1.5707963 0 0"/>
          <body name="osl_ankle_assembly" pos="{_f(0, 0, -_TIBIA_LEN)}">
            <inertial pos="0 0 -0.01" mass="0.7" diaginertia="0.002 0.002 0.001"/>
            <joint name="osl_ankle_angle_r" axis="0 -1 0" range="-0.5 0.5" damping="1" armature="0.005"/>
            <geom name="osl_ankle_assembly_geom_1" type="mesh" mesh="osl_ankle" {hull}/>
            <site name="r_osl_load" pos="0 0 0.02" euler="1.5707963 0 0"/>
            <body name="osl_foot_assembly" pos="{_f(0, 0, -_TALUS_LEN)}">
              <inertial pos="0.05 0 -0.02" mass="0.6" diaginertia="0.002 0.002 0.0006"/>
              <geom name="osl_heel" type="sphere" pos="-0.05 0 -0.02" size="0.03" {foot}/>
              <geom name="osl_sole" type="capsule" fromto="-0.03 0 -0.025 0.12 0 -0.025" size="0.025" {foot}/>
              <geom name="osl_toe_bar" type="capsule" fromto="0.155 0.03 -0.03 0.155 -0.03 -0.03" size="0.02" {foot}/>
              <geom name="osl_toe_tip" type="sphere" pos="0.195 0 -0.035" size="0.015" {foot}/>
              <site name="r_osl_foot" pos="0.07 0 -0.04" size="0.14 0.05 0.03" type="box"/>
              <site name="r_heel_btm" pos="-0.05 0 -0.05"/>
              <site name="r_toe_btm" pos="0.195 0 -0.05"/>
            </body>
          </body>
        </body>
      </body>"""


def _osl_joint_order() -> list[str]:
  """The scene's joints after the root, in qpos order."""
  left = ["hip_flexion_l", "hip_adduction_l", "hip_rotation_l"]
  left += [j[0] for j in _OSL_PATELLA]
  left += ["knee_angle_l_translation2", "knee_angle_l_translation1",
           "knee_angle_l", "knee_angle_l_rotation2", "knee_angle_l_rotation3",
           "ankle_angle_l", "subtalar_angle_l", "mtp_angle_l"]
  return left + ["hip_flexion_r", "hip_adduction_r", "hip_rotation_r",
                 "osl_knee_angle_r", "osl_ankle_angle_r"]


def _osl_pose(joints: dict) -> dict:
  """Joint values by name with the left knee's coupled joints set on
  their curves from ``knee_angle_l`` (0 for joints not given)."""
  out = {j: 0.0 for j in _osl_joint_order()}
  out.update(joints)
  for name, *_, coef in _OSL_PATELLA + _OSL_TIBIA:
    out[name] = _couple(out["knee_angle_l"], coef)
  return out


def _osl_key(joints: dict, speed: float, drop: float = 0.0) -> str:
  """A keyframe: the pelvis ``drop`` m under the standing height facing
  -y at ``speed`` m/s forward, and the joints (``_osl_pose``)."""
  pose = _osl_pose(joints)
  qpos = [0.0, 0.0, _PELVIS_HEIGHT - drop, *_OSL_YAW_QUAT]
  qpos += [pose[j] for j in _osl_joint_order()]
  qvel = [0.0, -speed] + [0.0] * (4 + len(pose))
  return f'<key qpos="{_f(*qpos)}" qvel="{_f(*qvel)}"/>'


# standing at a walk's speed (OSL in early stance); the OSL leg in early
# swing; the OSL heel strike with the left leg pushing off
_OSL_KEYS = (
    (dict(), 1.0, 0.0),
    (dict(hip_flexion_r=0.4, osl_knee_angle_r=0.8, osl_ankle_angle_r=0.1,
          hip_flexion_l=-0.15, knee_angle_l=0.1, ankle_angle_l=0.05),
     1.2, 0.01),
    (dict(hip_flexion_r=0.3, osl_knee_angle_r=0.05, hip_flexion_l=-0.3,
          knee_angle_l=0.4, ankle_angle_l=-0.2), 1.2, 0.03),
)


def osl_fixture_xml() -> str:
  """MJCF text of the synthetic OSL RunTrack scene ("osl54").

  - ``pelvis`` on a free joint with the ``torso`` welded on top and a
    ``head`` site 1.71 m over the floor when standing;
  - a biological left leg with MyoSuite's 14 left joints: the hip's
    three, ``knee_angle_l`` and, coupled to it by joint equalities,
    ``knee_angle_l_translation1/2`` and ``_rotation2/3`` (tibia) and the
    three ``_beta_`` joints (a ``patella_l`` body); ankle, subtalar and
    mtp; touch sites ``l_foot`` and ``l_toes``, ``l_heel_btm`` and
    ``l_toe_btm``;
  - the right hip's three joints on the residual ``femur_r``, then the
    OSL chain: ``osl_knee_assembly`` (``osl_knee_angle_r``),
    ``osl_ankle_assembly`` (``osl_ankle_angle_r``) and
    ``osl_foot_assembly``; the knee and ankle carry convex prism hulls
    (inline meshes, as the JAX package substitutes for the missing
    prosthesis meshes), colliding with the floor only; force sensors
    ``r_socket_load`` and ``r_osl_load`` on sites whose y axis points up
    the shank, touch ``r_osl_foot``, ``r_heel_btm`` and ``r_toe_btm``;
  - the 54 muscles named as MyoSuite's (``run_track.BIOLOGICAL_ACT``) on
    the two-leg scene's paths, then motors ``osl_knee_torque_actuator``
    and ``osl_ankle_torque_actuator`` (gear ``OSL_GEAR``, ctrl in
    [-1, 1]): nu 56, na 54, nv 25;
  - a floor plane and the track hfield ``terrain`` (``_OSL_HFIELD``, flat
    until a task overlays it) centred at the origin;
  - three keyframes facing -y with a forward speed: standing, the OSL leg
    in early swing, the OSL heel strike.
  """
  sites, tendons, muscles = _osl_muscles()
  leg_sites = {b: s for (side, b), s in sites.items() if side == "l"}
  knee, patella, equalities = _coupled_knee("l", "patella_bone")
  left = _leg("l", leg_sites, knee=knee, patella=patella, btm=True)
  pelvis_sites = sites.get(("l", "pelvis"), "") + sites.get(("r", "pelvis"),
                                                            "")
  hip_parts = "".join(
      f"""
      <geom name="hip_wrap_{s}" type="sphere" pos="{_f(_LEG_HIP[0], m * _LEG_HIP[1], _LEG_HIP[2])}" size="0.035" contype="0" conaffinity="0"/>
      <site name="hip_front_{s}" pos="{_f(0.07, m * _LEG_HIP[1], _LEG_HIP[2])}"/>"""
      for s, m in (("l", 1.0), ("r", -1.0)))
  motors = "\n    ".join(
      f'<motor name="osl_{j}_torque_actuator" joint="osl_{j}_angle_r" '
      f'gear="{g:g}" ctrlrange="-1 1"/>'
      for j, g in zip(("knee", "ankle"), OSL_GEAR))
  keys = "\n    ".join(_osl_key(*k) for k in _OSL_KEYS)
  nrow, ncol, size = _OSL_HFIELD
  ground = f'contype="{_GROUND_BITS}"'
  return f"""<mujoco model="osl54">
  <compiler angle="radian" autolimits="true"/>
  <option timestep="0.002" iterations="100" ls_iterations="50"/>
  <asset>
    <hfield name="terrain" nrow="{nrow}" ncol="{ncol}" size="{_f(*size)}"/>
    <mesh name="osl_knee" vertex="{_prism_vertices(*_OSL_KNEE_HULL)}"/>
    <mesh name="osl_ankle" vertex="{_prism_vertices(*_OSL_ANKLE_HULL)}"/>
  </asset>
  <worldbody>
    <geom name="floor" type="plane" size="2 70 0.1" {ground} conaffinity="{_GROUND_BITS | _FOOT_BITS | _HULL_BIT}"/>
    <geom name="terrain" type="hfield" hfield="terrain" {ground} conaffinity="{_GROUND_BITS | _FOOT_BITS}"/>
    <body name="pelvis" pos="{_f(0, 0, _PELVIS_HEIGHT)}" quat="{_f(*_OSL_YAW_QUAT)}">
      <freejoint name="root"/>
      <inertial pos="0 0 0" mass="11.5" diaginertia="0.1 0.09 0.08"/>
      <geom name="pelvis_bone" type="capsule" fromto="0 -0.1 0 0 0.1 0" size="0.07" contype="0" conaffinity="0"/>
      <site name="pelvis"/>{hip_parts}{pelvis_sites}
      <body name="torso" pos="0 0 0.1">
        <inertial pos="0 0 0.24" mass="30" diaginertia="1.3 1.2 0.3"/>
        <geom name="torso_bone" type="capsule" fromto="0 0 0.05 0 0 0.45" size="0.13" contype="0" conaffinity="0"/>
        <site name="head" pos="0 0 0.65"/>
      </body>{left}{_osl_prosthesis(sites)}
    </body>
  </worldbody>
  <equality>
    {equalities}
  </equality>
  <tendon>
    {tendons}
  </tendon>
  <actuator>
    {muscles}
    {motors}
  </actuator>
  <sensor>
    <touch name="l_foot" site="l_foot"/>
    <touch name="l_toes" site="l_toes"/>
    <touch name="r_osl_foot" site="r_osl_foot"/>
    <force name="r_osl_load" site="r_osl_load"/>
    <force name="r_socket_load" site="r_socket_load"/>
  </sensor>
  <keyframe>
    {keys}
  </keyframe>
</mujoco>
"""


def _smooth(x: np.ndarray) -> np.ndarray:
  """A smooth step over [0, 1]."""
  x = np.clip(x, 0.0, 1.0)
  return x * x * (3.0 - 2.0 * x)


def _gait_leg(phase: np.ndarray) -> dict:
  """One leg's hip, knee and ankle over a gait cycle starting at toe-off
  (swing for the first 40%, then stance)."""
  swing = phase < 0.4
  knee = np.where(swing, 1.0 * np.sin(np.pi * phase / 0.4),
                  0.15 * np.sin(np.pi * (phase - 0.4) / 0.6))
  hip = 0.4 * np.cos(2 * np.pi * (phase - 0.35))
  ankle = np.where(swing, 0.1,
                   0.05 - 0.2 * np.clip((phase - 0.75) / 0.25, 0, 1))
  return dict(hip=hip, knee=knee, ankle=ankle)


def osl_gait_table() -> tuple[list[str], np.ndarray]:
  """The synthetic gait cycle of the OSL scene: (header, rows
  [_OSL_GAIT_ROWS, columns]), the columns the run-track task's
  ``osl_init`` reset reads: joints (the left knee's coupled joints on
  their curves), the pelvis's Euler angles (facing -y), the feet's
  positions relative to the pelvis and the pelvis's velocity in its
  heading frame. The OSL leg swings for the first 99 rows and stands for
  the rest, as the reference's row-to-state map has it; the left leg is
  half a cycle behind."""
  phase = np.arange(_OSL_GAIT_ROWS) / _OSL_GAIT_ROWS
  r, l = _gait_leg(phase), _gait_leg((phase + 0.5) % 1.0)
  c, s = np.cos(2 * np.pi * phase), np.sin(2 * np.pi * phase)
  cols = {
      "hip_flexion_l": l["hip"], "hip_adduction_l": 0.05 * s,
      "hip_rotation_l": 0.04 * c, "knee_angle_l": l["knee"],
      "ankle_angle_l": l["ankle"], "subtalar_angle_l": 0.02 * s,
      "mtp_angle_l": 0.2 * np.clip(1 - np.abs(((phase + 0.5) % 1.0)
                                               - 0.95) / 0.1, 0, 1),
      "hip_flexion_r": r["hip"], "hip_adduction_r": -0.05 * s,
      "hip_rotation_r": -0.04 * c, "osl_knee_angle_r": r["knee"],
      "osl_ankle_angle_r": r["ankle"],
  }
  for name, *_, coef in _OSL_PATELLA + _OSL_TIBIA:
    cols[name] = _couple(cols["knee_angle_l"], coef)
  cols.update({
      "pelvis_euler_roll": 0.03 * s,
      "pelvis_euler_pitch": 0.05 + 0.02 * np.sin(4 * np.pi * phase),
      "pelvis_euler_yaw": -np.pi / 2 + 0.04 * s,
      "l_foot_relative_X": 0.25 * np.sin(2 * np.pi * (phase + 0.5)),
      "l_foot_relative_Y": np.full_like(phase, 0.085),
      "l_foot_relative_Z": -0.9 + 0.05 * l["knee"],
      "r_foot_relative_X": 0.25 * s,
      "r_foot_relative_Y": np.full_like(phase, -0.085),
      "r_foot_relative_Z": -0.9 + 0.05 * r["knee"],
      "pelvis_vel_X": 1.3 + 0.1 * np.cos(4 * np.pi * phase),
      "pelvis_vel_Y": 0.03 * s,
      "pelvis_vel_Z": 0.1 * np.sin(4 * np.pi * phase),
  })
  header = list(cols)
  return header, np.round(np.stack([cols[h] for h in header], 1), 6)


def osl_gait_csv() -> str:
  """``osl_gait_table`` as CSV text: a header line, then one line per
  row."""
  header, rows = osl_gait_table()
  lines = [",".join(header)]
  lines += [",".join(f"{x:.6f}" for x in row) for row in rows]
  return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# track: MyoDM's tracking scene, a hand on a 6-dof base over a table with
# one object on 3 slides and 3 hinges
# ---------------------------------------------------------------------------

_TRACK_OBJECT = "cubesmall"
_CUBE_HALF = 0.025
# the object rests on the table at the reference's height of 0.1
_TRACK_TABLE = 0.1 - _CUBE_HALF
# the forearm (the base body) with the palm over the object, palm down
_TRACK_FOREARM = (-0.16, 0.0, 0.156)
# base joints: name, type, axis, half range, damping, position gain
_TRACK_BASE = (
    ("ARTx", "slide", (1, 0, 0), 0.05, 30.0, 1500.0),
    ("ARTy", "slide", (0, 1, 0), 0.05, 30.0, 1500.0),
    ("ARTz", "slide", (0, 0, 1), 0.05, 30.0, 1500.0),
    ("ARRx", "hinge", (1, 0, 0), 0.3, 1.0, 30.0),
    ("ARRy", "hinge", (0, 1, 0), 0.3, 1.0, 30.0),
    ("ARRz", "hinge", (0, 0, 1), 0.3, 1.0, 30.0),
)


def track_fixture_xml(digits: int = 5) -> str:
  """MJCF text of the tracking scene: the hand (``hand_fixture_xml``'s
  digits) palm down, its forearm on six base joints ``ARTx``/``y``/``z``
  (slides) and ``ARRx``/``y``/``z`` (hinges) driven by position actuators
  after the muscles; the palm body is named ``lunate`` (MyoHand's wrist
  bone), with a colliding pad under it. ``cubesmall``, a convex mesh cube
  of 5 cm on slides ``OBJTx``/``y``/``z`` and hinges ``OBJRx``/``y``/``z``
  (so its Euler angles are intrinsic XYZ), rests on a ``table`` plane at
  the reference's height under the palm at qpos (0, 0, 0.1). It collides
  with the table, the distal phalanges and the pad. The robot's dofs come
  first: digits 5 gives track29 (29 robot dofs, MyoDM's width; nv 35),
  digits 2 track17 (nv 23).
  """
  inner = "".join(
      f"\n      {_joint_xml(n, k, a, (-h, h), f' damping={chr(34)}{d:g}{chr(34)} armature={chr(34)}0.01{chr(34)}')}"
      for n, k, a, h, d, _ in _TRACK_BASE)
  palm_pad = f"""
          <geom name="palm_pad" type="capsule" fromto="0.012 -0.01 -0.006 0.062 -0.01 -0.006" size="0.02" contype="{_PALM_BIT}" conaffinity="0"/>"""
  body, tendons, muscles = _forearm_body(
      digits, f'pos="{_f(*_TRACK_FOREARM)}"', 'axis="1 0 0" range="-1.0 1.0"',
      palm_pad, inner=inner)
  body = body.replace('<body name="palm" ', '<body name="lunate" ', 1)
  h = _CUBE_HALF
  verts = " ".join(_f(x, y, z) for x in (-h, h) for y in (-h, h)
                   for z in (-h, h))
  obj_bits = f'contype="{_OBJECT_BIT}" conaffinity="{1 | _PALM_BIT}"'
  obj_joints = "".join(
      f'\n      <joint name="OBJT{a}" type="slide" axis="{_f(*v)}" damping="0.01"/>'
      for a, v in zip("xyz", ((1, 0, 0), (0, 1, 0), (0, 0, 1))))
  obj_joints += "".join(
      f'\n      <joint name="OBJR{a}" type="hinge" axis="{_f(*v)}" damping="0.0002" armature="0.00002"/>'
      for a, v in zip("xyz", ((1, 0, 0), (0, 1, 0), (0, 0, 1))))
  obj = f"""
    <body name="{_TRACK_OBJECT}" pos="0 0 0">{obj_joints}
      <geom name="{_TRACK_OBJECT}" type="mesh" mesh="{_TRACK_OBJECT}" mass="0.05" {obj_bits}/>
      <site name="object_o" size="0.005"/>
    </body>"""
  base = "\n    ".join(
      f'<position name="{n}" joint="{n}" kp="{kp:g}" ctrlrange="{_f(-hr, hr)}"/>'
      for n, _, _, hr, _, kp in _TRACK_BASE)
  return f"""<mujoco model="track{9 + 4 * digits}">
  <compiler angle="radian" autolimits="true"/>
  <option timestep="0.002" iterations="100" ls_iterations="50"/>
  <asset>
    <mesh name="{_TRACK_OBJECT}" vertex="{verts}"/>
  </asset>
  <worldbody>
    <geom name="table" type="plane" pos="0 0 {_TRACK_TABLE:g}" size="0.6 0.6 0.05" contype="1" conaffinity="1"/>{body}{obj}
  </worldbody>
  <tendon>{tendons}
  </tendon>
  <actuator>
    {muscles}
    {base}
  </actuator>
</mujoco>
"""


def _track_robot(t: np.ndarray, rd: int, s: np.ndarray, kind: str):
  """A robot trajectory [T, rd] (base dofs first) and its time
  derivative, for a smooth step ``s`` of time ``t``."""
  ds = np.gradient(s, t)
  j = np.arange(rd - 6)
  pattern = 0.15 * np.sin(1.3 * (j + 1) + (0.0 if kind == "lift" else 0.7))
  robot = np.zeros((len(t), rd))
  vel = np.zeros((len(t), rd))
  base = {"lift": (2, 0.04), "inspect": (3, 0.1)}[kind]
  robot[:, base[0]] = base[1] * s
  vel[:, base[0]] = base[1] * ds
  robot[:, 6:] = s[:, None] * pattern
  vel[:, 6:] = ds[:, None] * pattern
  return robot, vel


def _axis_quat(axis, angle: np.ndarray) -> np.ndarray:
  a = np.asarray(axis, np.float64)
  return np.concatenate([np.cos(angle / 2)[:, None],
                         np.sin(angle / 2)[:, None] * a], 1)


def _quat_mul(u: np.ndarray, v: np.ndarray) -> np.ndarray:
  w1, x1, y1, z1 = u.T
  w2, x2, y2, z2 = v.T
  return np.stack([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                   w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                   w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                   w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], 1)


def track_clips(digits: int = 5) -> dict[str, dict[str, np.ndarray]]:
  """Synthetic MyoDM clips for the tracking scene of ``digits``: clip name
  -> {time, robot, [robot_vel,] object}. ``lift`` (2 s, 41 frames, with
  ``robot_vel``): the object rises 5 cm from its resting pose turning
  0.3 rad about z while the base rises; ``inspect`` (1.2 s, 25 frames,
  no ``robot_vel``: the task takes the time gradient): the object rises
  2 cm, sways along x and turns about x and z. Object quaternions are
  unit; every clip starts at the object's resting pose (0, 0, 0.1)."""
  rd = 9 + 4 * digits
  out = {}
  for kind, (duration, frames) in (("lift", (2.0, 41)),
                                   ("inspect", (1.2, 25))):
    t = np.round(np.linspace(0.0, duration, frames), 4)
    s = _smooth(t / duration)
    robot, vel = _track_robot(t, rd, s, kind)
    pos = np.zeros((frames, 3))
    pos[:, 2] = 0.1
    if kind == "lift":
      pos[:, 2] += 0.05 * s
      quat = _axis_quat((0, 0, 1), 0.3 * s)
    else:
      pos[:, 0] = 0.01 * np.sin(np.pi * t / duration)
      pos[:, 2] += 0.02 * s
      quat = _quat_mul(_axis_quat((1, 0, 0), 0.6 * s),
                       _axis_quat((0, 0, 1), 0.2 * s))
    quat = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    clip = {"time": t, "robot": robot, "object": np.concatenate(
        [pos, quat], 1)}
    if kind == "lift":
      clip["robot_vel"] = vel
    out[kind] = clip
  return out


# ---------------------------------------------------------------------------
# chain72: the scene with nv > 64
# ---------------------------------------------------------------------------

CHAIN_LINKS = 72
_CHAIN_HANGING = 61       # links hanging straight down from the base
_CHAIN_LEN = 0.02         # link length
_CHAIN_RADIUS = 0.008
_CHAIN_SINK = 0.0005      # the lying links start this far in the floor


def chain_fixture_xml(links: int = CHAIN_LINKS,
                      hanging: int = _CHAIN_HANGING) -> str:
  """A chain of ``links`` hinged capsule links hanging from a fixed base
  and lying on a plane ("chain72", nv 72, the default).

  The first ``hanging`` links hang straight down from the base; the rest
  turn a right angle at the floor and lie along +x on it, 0.5 mm deep so
  that their contacts are clearly active (11 lying links: 22 contact
  points, plus the corner link's end, within the 24 contact slots). Every
  hinge is about y, so the chain is a planar serial tree: the mass matrix
  is dense and Newton's H is nv x nv. The links collide with the floor
  only (contype 1, conaffinity 0 against the floor's 1 / 1). Hinges are
  damped, so the integrator takes the implicit solve. It is the scene
  whose solves exceed the register kernel's n <= 64.
  """
  z_base = hanging * _CHAIN_LEN + _CHAIN_RADIUS - _CHAIN_SINK
  link = (f'<joint name="hinge{{i}}" type="hinge" axis="0 1 0" '
          f'damping="0.002" armature="0.0001"/>'
          f'<geom name="link{{i}}" type="capsule" fromto="0 0 0 0 0 '
          f'{-_CHAIN_LEN}" size="{_CHAIN_RADIUS}" contype="1" '
          f'conaffinity="0"/>')
  body = ""
  for i in reversed(range(links)):
    pos = "0 0 0" if i == 0 else f"0 0 {-_CHAIN_LEN}"
    turn = ' euler="0 -1.5707963267948966 0"' if i == hanging else ""
    site = (f'<site name="chain_tip" pos="0 0 {-_CHAIN_LEN}"/>'
            if i == links - 1 else "")
    body = (f'<body name="c{i}" pos="{pos}"{turn}>'
            + link.format(i=i) + site + body + "</body>")
  return f"""<mujoco model="chain_fixture">
  <compiler angle="radian" autolimits="true"/>
  <option timestep="0.002" iterations="100" ls_iterations="50"/>
  <worldbody>
    <geom name="floor" type="plane" size="2 2 0.05" contype="1" conaffinity="1"/>
    <body name="base" pos="0 0 {z_base}">
      <geom name="mount" type="sphere" size="0.01" contype="0" conaffinity="0"/>
      {body}
    </body>
  </worldbody>
</mujoco>
"""
