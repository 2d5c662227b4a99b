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
            <site name="THtip" pos="{_f(l2, 0, 0)}"/>
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


def hand_fixture_xml(digits: int = 5, obj: str = "") -> str:
  """MJCF text of the synthetic hand: a thumb plus ``digits - 1`` fingers.

  With ``obj`` (worldbody MJCF of one object, see the object fixtures
  below) the hand is the object scenes' variant: the forearm is raised
  and turned thumb-up, as MyoHand's neutral posture, and pronation turns
  the other way, so that pro_sup = -1.5 (the tasks' palm-up init) turns
  the palm up; pro_sup's range reaches -1.6; a colliding pad lies on the
  palm; ``obj`` follows the hand in the worldbody.
  """
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
  if obj:
    forearm = f'pos="0 0 {_TURNED_HEIGHT:.6g}" euler="1.5708 0 0"'
    pro_sup = 'axis="-1 0 0" range="-1.6 1.0"'
    palm_pad = f"""
          <geom name="palm_pad" type="capsule" fromto="0.012 -0.01 -0.006 0.062 -0.01 -0.006" size="0.02" contype="{_PALM_BIT}" conaffinity="0"/>"""
  else:
    forearm = 'pos="0 0 0.052"'
    pro_sup = 'axis="1 0 0" range="-1.0 1.0"'
    palm_pad = ""
  return f"""<mujoco model="hand_fixture_{digits}">
  <compiler angle="radian" autolimits="true"/>
  <option timestep="0.002" iterations="100" ls_iterations="50"/>
  <worldbody>
    <geom name="floor" type="plane" size="0.5 0.5 0.05" contype="1" conaffinity="1"/>
    <body name="forearm" {forearm}>
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
        <joint name="pro_sup" {pro_sup} damping="0.03" armature="0.0004"/>
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
          <site name="palm_fpb2" pos="0.03 0.0152 -0.0117"/>{palm_pad}{palm_parts}{_thumb_body()}{finger_bodies}
        </body>
      </body>
    </body>{obj}
  </worldbody>
  <tendon>{tendons}
  </tendon>
  <actuator>
    {actuators}
  </actuator>
</mujoco>
"""


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


def _leg_muscles(side: str, count: int) -> tuple[dict, str, str]:
  """``count`` muscles of one leg from the templates: their sites per body
  (name -> MJCF), the spatial tendons and the actuators. The k-th use of
  a template shifts every site by a few millimetres so that no two
  muscles share a path."""
  mirror = 1.0 if side == "l" else -1.0
  sites: dict[str, list[str]] = {}
  tendons, actuators = [], []
  for i in range(count):
    name, force, path = _LEG_MUSCLES[i % len(_LEG_MUSCLES)]
    k = i // len(_LEG_MUSCLES)
    mname = f"{name}{k + 1}_{side}"
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


def _leg(side: str, sites: dict) -> str:
  """One leg from the hip down (femur, tibia, talus, calcn, toes)."""
  m = 1.0 if side == "l" else -1.0
  s = side
  foot = f'contype="{_FOOT_BITS}" conaffinity="{_GROUND_BITS}"'
  vis = 'contype="0" conaffinity="0"'
  hip = (_LEG_HIP[0], m * _LEG_HIP[1], _LEG_HIP[2])
  return f"""
      <body name="femur_{s}" pos="{_f(*hip)}">
        <inertial pos="0 0 -0.18" mass="8.5" diaginertia="0.14 0.14 0.025"/>
        <joint name="hip_flexion_{s}" axis="0 -1 0" range="-0.5 1.6" damping="4" stiffness="300" armature="0.01"/>
        <joint name="hip_adduction_{s}" axis="{_f(-m, 0, 0)}" range="-0.5 0.5" damping="4" stiffness="300" armature="0.01"/>
        <joint name="hip_rotation_{s}" axis="{_f(0, 0, m)}" range="-0.6 0.6" damping="4" stiffness="150" armature="0.01"/>
        <geom name="femur_bone_{s}" type="capsule" fromto="{_f(0, 0, 0, 0, 0, -_FEMUR_LEN)}" size="0.05" {vis}/>
        <geom name="knee_wrap_{s}" type="cylinder" pos="{_f(0, 0, -_FEMUR_LEN)}" zaxis="0 1 0" size="0.04 0.05" {vis}/>
        <site name="knee_front_{s}" pos="{_f(0.08, 0, -_FEMUR_LEN)}"/>
        <site name="knee_back_{s}" pos="{_f(-0.08, 0, -_FEMUR_LEN)}"/>{sites.get("femur", "")}
        <body name="tibia_{s}" pos="{_f(0, 0, -_FEMUR_LEN)}">
          <inertial pos="0 0 -0.17" mass="3.6" diaginertia="0.05 0.05 0.006"/>
          <joint name="knee_angle_{s}" axis="0 1 0" range="0 2.0" damping="4" stiffness="300" armature="0.01"/>
          <joint name="knee_angle_translation_{s}" type="slide" axis="1 0 0" range="-0.03 0.03" damping="20" armature="0.02"/>
          <geom name="tibia_bone_{s}" type="capsule" fromto="{_f(0, 0, -0.03, 0, 0, -_TIBIA_LEN)}" size="0.04" {vis}/>{sites.get("tibia", "")}
          <body name="talus_{s}" pos="{_f(0, 0, -_TIBIA_LEN)}">
            <inertial pos="0 0 -0.02" mass="0.1" diaginertia="0.0002 0.0002 0.0002"/>
            <joint name="ankle_angle_{s}" axis="0 -1 0" range="-0.7 0.5" damping="2" stiffness="200" armature="0.005"/>
            <body name="calcn_{s}" pos="{_f(0, 0, -_TALUS_LEN)}">
              <inertial pos="0.05 0 -0.02" mass="1.2" diaginertia="0.004 0.004 0.001"/>
              <joint name="subtalar_angle_{s}" axis="{_f(m, 0, 0.3)}" range="-0.35 0.35" damping="2" stiffness="100" armature="0.005"/>
              <geom name="heel_{s}" type="sphere" pos="-0.05 0 -0.02" size="0.03" {foot}/>
              <geom name="sole_{s}" type="capsule" fromto="-0.03 0 -0.025 0.12 0 -0.025" size="0.025" {foot}/>
              <site name="{s[0]}_foot" pos="0.03 0 -0.04" size="0.09 0.05 0.03" type="box"/>{sites.get("calcn", "")}
              <body name="toes_{s}" pos="0.15 0 -0.02">
                <inertial pos="0.02 0 -0.01" mass="0.2" diaginertia="0.0003 0.0003 0.0003"/>
                <joint name="mtp_angle_{s}" axis="0 -1 0" range="-0.5 0.9" damping="0.5" stiffness="30" armature="0.002"/>
                <geom name="toe_bar_{s}" type="capsule" fromto="{_f(0.005, -0.03, -0.01, 0.005, 0.03, -0.01)}" size="0.02" {foot}/>
                <geom name="toe_tip_{s}" type="sphere" pos="0.045 0 -0.015" size="0.015" {foot}/>
                <site name="{s[0]}_toes" pos="0.03 0 -0.025" size="0.04 0.05 0.02" type="box"/>{sites.get("toes", "")}
              </body>
            </body>
          </body>
        </body>
      </body>"""


def _leg_key(hip=(0.0, 0.0), knee=(0.0, 0.0), ankle=(0.0, 0.0),
             drop: float = 0.0) -> list[float]:
  """A keyframe's qpos: the pelvis ``drop`` m under the standing height,
  facing +y; hip flexion, knee and ankle angles per side (left, right);
  each knee's translation on its coupling curve."""
  def poly(q):
    return sum(c * q ** i for i, c in enumerate(KNEE_POLYCOEF))
  qpos = [0.0, 0.0, _PELVIS_HEIGHT - drop, 0.70710678, 0.0, 0.0, 0.70710678]
  for i in range(2):
    qpos += [hip[i], 0.0, 0.0, knee[i], poly(knee[i]), ankle[i], 0.0, 0.0]
  return qpos


# standing; a slight crouch; and two mid-stride poses (left leg forward,
# then right), whose pelvis drop keeps the stance foot on the ground
_LEG_KEYS = (
    _leg_key(),
    _leg_key(hip=(0.15, 0.15), knee=(0.3, 0.3), ankle=(0.15, 0.15),
             drop=0.0087),
    _leg_key(hip=(0.3, -0.2), knee=(0.15, 0.05), ankle=(0.05, 0.15),
             drop=0.0016),
    _leg_key(hip=(-0.2, 0.3), knee=(0.05, 0.15), ankle=(0.15, 0.05),
             drop=0.0016),
)


def legs_fixture_xml(muscles_per_leg: int = 40, chasetag: bool = False) -> str:
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
  - ``chasetag``: one mocap body ``opponent`` that collides with nothing.
  """
  if muscles_per_leg < 1:
    raise ValueError(f"muscles_per_leg must be positive, got "
                     f"{muscles_per_leg}")
  legs, tendons, actuators = [], [], []
  for side in ("l", "r"):
    sites, ten, act = _leg_muscles(side, muscles_per_leg)
    legs.append(_leg(side, sites))
    tendons.append(ten)
    actuators.append(act)
  pelvis_sites = "".join(
      _leg_muscles(s, muscles_per_leg)[0].get("pelvis", "") for s in "lr")
  hip_parts = "".join(
      f"""
      <geom name="hip_wrap_{s}" type="sphere" pos="{_f(_LEG_HIP[0], m * _LEG_HIP[1], _LEG_HIP[2])}" size="0.035" contype="0" conaffinity="0"/>
      <site name="hip_front_{s}" pos="{_f(0.07, m * _LEG_HIP[1], _LEG_HIP[2])}"/>"""
      for s, m in (("l", 1.0), ("r", -1.0)))
  nrow, ncol, size = _HFIELD
  keys = "\n    ".join(
      f'<key qpos="{_f(*q)}"/>' for q in _LEG_KEYS)
  opponent = ("""
    <body name="opponent" mocap="true" pos="2 2 0.9">
      <geom name="opponent_body" type="capsule" fromto="0 0 -0.5 0 0 0.5" size="0.15" contype="0" conaffinity="0"/>
    </body>""" if chasetag else "")
  equalities = "\n    ".join(
      f'<joint joint1="knee_angle_translation_{s}" joint2="knee_angle_{s}" '
      f'polycoef="{_f(*KNEE_POLYCOEF)}"/>' for s in "lr")
  name = f"legs{2 * muscles_per_leg}" + ("_chasetag" if chasetag else "")
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
