"""Synthetic muscle-tendon hand scenes at MyoHand's width.

``hand_fixture_xml(digits)`` returns MJCF text for a fixed forearm, a wrist
with three hinge dofs, a thumb with four and ``digits - 1`` fingers with four
each, in MyoHand's joint order (pro_sup, deviation, flexion, cmc_abduction,
cmc_flexion, mp_flexion, ip_flexion, then mcpN_flexion, mcpN_abduction,
pmN_flexion, mdN_flexion for each finger). Bones are capsules with joint
limits, damping and armature over a ground plane.

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
"""
from __future__ import annotations

# per finger (index, middle, ring, little): y offset of the knuckle, capsule
# radius, and the lengths of the proximal, middle and distal phalanges
_FINGERS = (
    (0.0185, 0.0088, 0.041, 0.026, 0.019),
    (-0.0012, 0.0091, 0.044, 0.028, 0.020),
    (-0.0207, 0.0085, 0.042, 0.026, 0.0185),
    (-0.0398, 0.0079, 0.035, 0.021, 0.017),
)
_THUMB_LEN = (0.035, 0.030, 0.022)
_THUMB_RADIUS = 0.0095


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


def _thumb_body() -> str:
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
            {_capsule("thumb_dist_bone", l2, r * 0.9, ct2, ca2, margin=0.001)}
            <site name="thumb_dist_fpl" pos="0.01 0 -0.0092"/>
            <site name="thumb_dist_epl" pos="0.01 0 0.0091"/>
          </body>
        </body>
      </body>"""


def _finger_body(k: int, y: float, r: float, l0: float, l1: float,
                 l2: float) -> str:
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
            {_capsule(f"f{k}_dist_bone", l2, r * 0.9, ctd, cad, margin=0.001)}
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


def hand_fixture_xml(digits: int = 5) -> str:
  """MJCF text of the synthetic hand: a thumb plus ``digits - 1`` fingers."""
  if not 1 <= digits <= 5:
    raise ValueError(f"digits must be in 1..5, got {digits}")
  fingers = [(k, *_FINGERS[k - 2]) for k in range(2, digits + 1)]
  palm_parts = "".join(_finger_palm_parts(k, y) for k, y, *_ in fingers)
  finger_bodies = "".join(_finger_body(*f) for f in fingers)
  tendons = (_WRIST_TENDONS + _THUMB_TENDONS
             + "".join(_finger_tendons(k) for k, *_ in fingers))
  muscles = [_muscle(n, 18.0 + 2.0 * i) for i, n in enumerate(_WRIST_MUSCLES)]
  muscles += [_muscle(n, 9.0 + 0.5 * i) for i, n in enumerate(_THUMB_MUSCLES)]
  for k, *_ in fingers:
    muscles += [_muscle(f"{n}{k}", 7.0 + 0.6 * i + 0.2 * k)
                for i, n in enumerate(_FINGER_MUSCLES)]
  actuators = "\n    ".join(muscles)
  return f"""<mujoco model="hand_fixture_{digits}">
  <compiler angle="radian" autolimits="true"/>
  <option timestep="0.002" iterations="100" ls_iterations="50"/>
  <worldbody>
    <geom name="floor" type="plane" size="0.5 0.5 0.05" contype="1" conaffinity="1"/>
    <body name="forearm" pos="0 0 0.052">
      <inertial pos="0.06 0 0" mass="0.3" diaginertia="0.00004 0.0004 0.0004"/>
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
        <joint name="pro_sup" axis="1 0 0" range="-1.0 1.0" damping="0.03" armature="0.0004"/>
        <geom name="radius_bone" type="capsule" fromto="0.06 0 0 0.11 0 0" size="0.011" contype="0" conaffinity="0"/>
        <geom name="wrist_wrap" type="sphere" pos="0.118 0 -0.001" size="0.0082" contype="0" conaffinity="0"/>
        <geom name="wrist_wrap_d" type="sphere" pos="0.117 -0.004 0.002" size="0.0075" contype="0" conaffinity="0"/>
        <site name="wrist_side" pos="0.118 0 -0.021"/>
        <site name="rad_pt" pos="0.08 0.0007 0.0132"/>
        <site name="rad_sup" pos="0.081 -0.0006 -0.0128"/>
        <body name="palm" pos="0.12 0 0">
          <inertial pos="0.04 -0.004 0" mass="0.07" diaginertia="0.000012 0.00004 0.00005"/>
          <joint name="deviation" axis="0 0 1" range="-0.25 0.35" damping="0.03" armature="0.0003"/>
          <joint name="flexion" axis="0 1 0" range="-0.8 0.8" damping="0.03" armature="0.0003"/>
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
          <site name="palm_fpb2" pos="0.03 0.0152 -0.0117"/>{palm_parts}{_thumb_body()}{finger_bodies}
        </body>
      </body>
    </body>
  </worldbody>
  <tendon>{tendons}
  </tendon>
  <actuator>
    {actuators}
  </actuator>
</mujoco>
"""
