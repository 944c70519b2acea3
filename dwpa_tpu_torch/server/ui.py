"""Server-rendered HTML pages (the reference's web/content/ CMS).

Behavioral equivalents of nets.php / search.php / stats.php / my_nets.php /
dicts.php / home.php / submit.php / get_key.php, rendered straight from the
sqlite core.  The three visibility tiers match the reference exactly
(nets.php:17-53):

- **bosskey** viewer sees every password;
- **anonymous** viewer sees 'Found' placeholders for cracked nets;
- **keyed** viewer additionally sees the real password for nets linked to
  their own user (the n2u join).

Uncracked nets render a per-net PSK input whose POST goes through
``build_cand`` -> put_work (nets.php:6-8) — crowdsourced manual cracking,
verified server-side like every other claim.
"""

import html
import time
from dataclasses import dataclass

from .core import ServerCore

PAGE_LIMIT = 20


@dataclass(frozen=True)
class Viewer:
    """Resolved identity of the requesting browser (cookie key)."""

    key: str = ""
    is_boss: bool = False
    u_id: int = None

    @property
    def tier(self) -> str:
        if self.is_boss:
            return "boss"
        return "keyed" if self.u_id is not None else "anonymous"


def resolve_viewer(core: ServerCore, key: str) -> Viewer:
    from .core import valid_key

    if not key or not valid_key(key):
        return Viewer()
    if core.bosskey and key == core.bosskey:
        return Viewer(key=key, is_boss=True)
    row = core.db.q1("SELECT u_id FROM users WHERE userkey = ?", (key,))
    return Viewer(key=key, u_id=row["u_id"] if row else None)


# ---------------------------------------------------------------------------
# display decoding (common.php:1036-1110)
# ---------------------------------------------------------------------------


def decode_keyver(keyver: int) -> str:
    return {1: "WPA", 2: "WPA2", 3: "WPA2_11w", 100: "PMKID"}.get(keyver, "UNC")


def decode_mp(mp, keyver: int) -> str:
    mp = int(mp or 0)
    if keyver == 100:
        if mp & 0x01:
            res = "AP"
        elif mp & 0x10:
            res = "CL"
        else:
            res = "UNK"
        if mp & 0b10:
            res += " possible FT"
        return res
    low = mp & 0b111
    res = {
        0b000: "M1M2/M2/U", 0b001: "M1M4/M4/A", 0b010: "M2M3/M2/A",
        0b011: "M2M3/M3/A", 0b100: "M3M4/M3/A", 0b101: "M3M4/M4/A",
    }.get(low, "UNK")
    if mp & 0b00010000:
        res += " AP-less"
    if mp & 0b10000000:
        res += " RCnC"
    if mp & 0b00100000:
        res += " LE"
    if mp & 0b01000000:
        res += " BE"
    return res


def decode_keyinfo(n_state, algo, nc, endian) -> str:
    if n_state == 2:
        return "Uncrackable"
    res = ""
    if algo:
        res += algo
    if nc:
        res += f" nc: {nc}"
    if endian:
        res += f" {endian}"
    return res.strip()


def convert_num(n: float) -> str:
    """Human units (common.php:995-1012)."""
    for unit in ("", "K", "M", "G", "T"):
        if abs(n) < 1000:
            return f"{n:.2f}".rstrip("0").rstrip(".") + unit
        n /= 1000
    return f"{n:.2f}P"


def convert_sec(sec: float) -> str:
    sec = int(sec)
    out = []
    for label, span in (("d", 86400), ("h", 3600), ("m", 60), ("s", 1)):
        if sec >= span or (label == "s" and not out):
            out.append(f"{sec // span}{label}")
            sec %= span
    return " ".join(out)


# ---------------------------------------------------------------------------
# nets table renderer (write_nets, common.php:1113-1168)
# ---------------------------------------------------------------------------


_NET_COLS = (
    "n.hash AS hash, n.bssid, n.ssid, n.keyver, n.message_pair, n.algo, "
    "n.nc, n.endian, n.hits, n.ts, n.n_state, b.country"
)


def _pass_select(viewer: Viewer) -> str:
    """The tier-dependent password column (nets.php:17-53)."""
    if viewer.is_boss:
        return "n.pass AS pass"
    if viewer.u_id is not None:
        return (
            "CASE WHEN n2u.u_id IS NOT NULL THEN n.pass "
            "WHEN n.pass IS NOT NULL THEN CAST('Found' AS BLOB) "
            "ELSE NULL END AS pass"
        )
    return (
        "CASE WHEN n.pass IS NOT NULL THEN CAST('Found' AS BLOB) "
        "ELSE NULL END AS pass"
    )


def _viewer_join(viewer: Viewer) -> str:
    if viewer.u_id is not None and not viewer.is_boss:
        return "LEFT JOIN n2u ON n2u.net_id = n.net_id AND n2u.u_id = :uid"
    return ""


def write_nets(rows) -> str:
    out = [
        '<form class="form" method="post">',
        '<table class="nets">',
        "<tr><th>CC</th><th>BSSID</th><th>SSID</th><th>Type</th><th>Feat</th>"
        "<th>WPA key</th><th>Key info</th><th>Get works</th><th>Timestamp</th></tr>",
    ]
    has_input = False
    for r in rows:
        bssid = f"{r['bssid']:012x}"
        ssid = html.escape(r["ssid"].decode("utf-8", "replace"))
        if r["n_state"] == 0:
            has_input = True
            key_cell = f'<input class="input" name="{r["hash"].hex()}">'
        else:
            p = r["pass"]
            key_cell = html.escape((p or b"").decode("utf-8", "replace"))
        cc = (r["country"] or "xx").lower()
        ts = time.strftime("%Y-%m-%d %H:%M:%S", time.gmtime(r["ts"]))
        out.append(
            f'<tr><td>{cc}</td>'
            f'<td class="bssid"><a href="https://wigle.net/search?netid='
            f'{":".join(bssid[i:i+2] for i in range(0, 12, 2))}">{bssid}</a></td>'
            f"<td>{ssid}</td><td>{decode_keyver(r['keyver'])}</td>"
            f"<td>{decode_mp(r['message_pair'], r['keyver'])}</td>"
            f"<td>{key_cell}</td>"
            f"<td>{decode_keyinfo(r['n_state'], r['algo'], r['nc'], r['endian'])}</td>"
            f"<td>{r['hits']}</td><td>{ts}</td></tr>"
        )
    out.append("</table>")
    if has_input:
        out.append('<br><input class="btn" type="submit" value="Send WPA keys">')
    out.append("</form>")
    return "\n".join(out)


def _query_nets(core: ServerCore, viewer: Viewer, where: str, params: dict,
                order: str = "n.ts DESC", limit: int = PAGE_LIMIT,
                offset: int = 0) -> list:
    params = dict(params, lim=limit, off=offset)
    join = _viewer_join(viewer)
    if join:
        params["uid"] = viewer.u_id
    sql = f"""SELECT {_NET_COLS}, {_pass_select(viewer)}
              FROM nets n LEFT JOIN bssids b ON n.bssid = b.bssid
              {join}
              WHERE {where} ORDER BY {order} LIMIT :lim OFFSET :off"""
    return core.db.q(sql, params)


# ---------------------------------------------------------------------------
# pages
# ---------------------------------------------------------------------------


def page_nets(core: ServerCore, viewer: Viewer) -> str:
    """Last 20 submitted networks (nets.php)."""
    rows = _query_nets(core, viewer, "n.n_state < 2", {})
    return "<h1>Last 20 submitted networks</h1>\n" + write_nets(rows)


def page_search(core: ServerCore, viewer: Viewer, search: str) -> str:
    """BSSID / OUI / client-MAC / SSID search (search.php:12-117)."""
    out = ["<h1>Search networks</h1>"]
    out.append(
        '<form method="get">'
        f'<input class="input" name="search" value="{html.escape(search)}">'
        '<input class="btn" type="submit" value="Search"></form>'
    )
    if len(search) >= 3:
        column = "bssid"
        if search.startswith("client:"):
            search = search[7:].strip()
            column = "mac_sta"
        mac = search.replace(":", "").replace("-", "").lower()
        if len(mac) == 12 and all(c in "0123456789abcdef" for c in mac):
            rows = _query_nets(
                core, viewer, f"n.{column} = :mac AND n.n_state < 2",
                {"mac": int(mac, 16)},
            )
        elif len(mac) == 6 and all(c in "0123456789abcdef" for c in mac):
            # OUI match: top 24 bits (search.php:59-85)
            rows = _query_nets(
                core, viewer, f"(n.{column} >> 24) = :oui AND n.n_state < 2",
                {"oui": int(mac, 16)},
            )
        else:
            like = search if ("_" in search or "%" in search) else search + "%"
            # ssid is a BLOB column; sqlite's LIKE is false for blob
            # operands, so compare through a text cast
            rows = _query_nets(
                core, viewer,
                "CAST(n.ssid AS TEXT) LIKE :ssid AND n.n_state < 2",
                {"ssid": like},
            )
        out.append(write_nets(rows))
    return "\n".join(out)


def page_my_nets(core: ServerCore, viewer: Viewer, page: int = 1) -> str:
    """Paginated per-user nets + potfile download link (my_nets.php)."""
    out = ["<h1>My networks</h1>"]
    if viewer.u_id is None:
        out.append("No user key set.")
        return "\n".join(out)
    offset = (max(1, page) - 1) * PAGE_LIMIT
    rows = core.db.q(
        f"""SELECT {_NET_COLS}, n.pass AS pass
            FROM nets n JOIN n2u ON n.net_id = n2u.net_id
            LEFT JOIN bssids b ON n.bssid = b.bssid
            WHERE n2u.u_id = :uid AND n.n_state < 2
            ORDER BY n.ts DESC, n.bssid ASC LIMIT :lim OFFSET :off""",
        {"uid": viewer.u_id, "lim": PAGE_LIMIT, "off": offset},
    )
    total = core.db.q1(
        "SELECT COUNT(*) c FROM nets n JOIN n2u ON n.net_id = n2u.net_id "
        "WHERE n2u.u_id = ? AND n.n_state < 2",
        (viewer.u_id,),
    )["c"]
    out.append(write_nets(rows))
    out.append('<a href="?api&dl=1" class="btn">Download all founds</a>')
    pages = -(-total // PAGE_LIMIT)
    out.append('<div class="pagination">')
    for i in range(1, pages + 1):
        if i == page:
            out.append(f'<span class="btn active">{i}</span>')
        else:
            out.append(f'<a href="?my_nets&page={i}" class="btn">{i}</a>')
    out.append("</div>")
    return "\n".join(out)


def page_stats(core: ServerCore) -> str:
    """Totals, splits, 24h perf, contributors, round ETA + progress bar
    (stats.php:5-84)."""
    s = {r["name"]: r["value"] for r in core.db.q("SELECT name, value FROM stats")}
    g = lambda k: int(s.get(k, 0))
    out = ["<h1>Statistics</h1>"]
    out.append(f"Total nets: {g('nets')}<br>")
    out.append(f"Cracked nets: {g('cracked')} / Uncracked: {g('uncracked')}<br>")
    if g("nets"):
        out.append(f"Success rate: {g('cracked') / g('nets') * 100:.2f}%<br>")
    out.append(f"PMKID nets: {g('pmkid')} / cracked: {g('pmkid_cracked')}<br>")
    out.append(
        f"Cracked by known algorithm: {g('rkg_cracked')} / {g('rkg')}<br>"
    )
    if g("geo"):
        out.append(f"Geolocated nets: {g('geo')}<br>")
    out.append(f"Last 24h processed nets: {g('24getwork')}<br>")
    out.append(f"Last 24h performance: {convert_num(g('24psk') / 86400)}/s<br>")
    out.append(f"Last 24h submissions: {g('24sub')}<br>")
    out.append(f"Last 24h founds: {g('24founds')}<br>")
    live = core.db.q1(
        "SELECT COUNT(DISTINCT hkey) d, COUNT(hkey) t FROM n2d "
        "WHERE hkey IS NOT NULL"
    )
    out.append(
        f"Current contributors count: {live['d']} working on {live['t']} nets<br>"
    )
    rate = g("24psk") / 86400
    remaining = g("words") - g("triedwords")
    eta = convert_sec(remaining / rate) if rate > 0 else "infinity"
    out.append(f"Current round ends in: {eta}<br>")
    words = g("words") or 1
    pct = round(g("triedwords") / words * 100, 2)
    out.append(
        f'Current keyspace progress: <dl class="progress">'
        f'<dd class="done" style="width: {pct}%">{pct}%</dd></dl>'
    )
    return "\n".join(out)


def page_dicts(core: ServerCore) -> str:
    rows = core.db.q(
        "SELECT dpath, dname, wcount, hits FROM dicts "
        "ORDER BY wcount DESC, dname DESC"
    )
    out = [
        "<h1>Dictionaries</h1>",
        '<table class="dicts">',
        "<tr><th>Dictionary</th><th>Word count</th><th>Hits</th></tr>",
    ]
    for r in rows:
        out.append(
            f'<tr><td><a href="{html.escape(r["dpath"])}">'
            f'{html.escape(r["dname"])}</a></td>'
            f"<td>{r['wcount']}</td><td>{r['hits']}</td></tr>"
        )
    out.append("</table>")
    out.append('Keygen generated dict: <a href="dict/rkg.txt.gz">rkg.txt.gz</a>')
    return "\n".join(out)


def page_home() -> str:
    return (
        "<h1>dwpa_tpu — distributed WPA security audit</h1>\n"
        "<p>Upload a capture (?submit), fetch your key (?get_key), watch "
        "progress (?stats). Volunteer clients crack work units on TPU "
        "meshes and every claimed PSK is independently re-verified.</p>"
    )


def page_submit() -> str:
    return (
        "<h1>Submit capture</h1>\n"
        '<form method="post" enctype="multipart/form-data">'
        '<input type="file" name="file">'
        '<input class="btn" type="submit" value="Upload"></form>'
    )


def page_get_key(message: str = None, has_key: bool = False) -> str:
    out = ["<h1>Get key</h1>"]
    if message:
        out.append(html.escape(message))
    elif has_key:
        out.append("Key already issued.")
    else:
        out.append(
            '<form method="post">'
            '<input class="input" name="mail" placeholder="e-mail">'
            '<input class="btn" type="submit" value="Get key"></form>'
        )
    return "\n".join(out)


def render(body: str, title: str = "dwpa_tpu") -> bytes:
    return (
        f"<!DOCTYPE html><html><head><title>{html.escape(title)}</title></head>"
        "<body>"
        '<nav><a href="?nets">nets</a> <a href="?search">search</a> '
        '<a href="?stats">stats</a> <a href="?my_nets">my nets</a> '
        '<a href="?dicts">dicts</a> <a href="?submit">submit</a> '
        '<a href="?get_key">get key</a></nav><hr>'
        f"{body}</body></html>"
    ).encode()
