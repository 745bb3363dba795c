/* Dashboard SPA: hash-routed vanilla ES module.
 *
 * Views consume the web-app backends exactly where the gateway mounts
 * them (manifests path routing / webapps.gateway):
 *   /api/...              central dashboard
 *   /jupyter/api/...      jupyter web app (spawner)
 *   /volumes/api/...      volumes web app
 *   /tensorboards/api/... tensorboards web app
 *   /kfam/kfam/v1/...     access management
 * CSRF: double-submit — echo the XSRF-TOKEN cookie in X-XSRF-TOKEN on
 * unsafe methods (crud_backend contract, webapps/core.py).
 */

const $ = (sel, el = document) => el.querySelector(sel);
const view = $("#view");

// ---- api client ------------------------------------------------------

function csrfToken() {
  const m = document.cookie.match(/(?:^|;\s*)XSRF-TOKEN=([^;]+)/);
  return m ? decodeURIComponent(m[1]) : "";
}

async function api(method, url, body) {
  const opts = { method, headers: {} };
  if (!["GET", "HEAD"].includes(method)) {
    opts.headers["X-XSRF-TOKEN"] = csrfToken();
  }
  if (body !== undefined) {
    opts.headers["Content-Type"] = "application/json";
    opts.body = JSON.stringify(body);
  }
  const resp = await fetch(url, opts);
  let data = {};
  try { data = await resp.json(); } catch { /* non-JSON error body */ }
  if (!resp.ok || data.success === false) {
    throw new Error(data.log || `${method} ${url}: HTTP ${resp.status}`);
  }
  return data;
}

const get = (url) => api("GET", url);
const post = (url, body) => api("POST", url, body);
const patch = (url, body) => api("PATCH", url, body);
const del = (url) => api("DELETE", url);

// ---- shared state ----------------------------------------------------

const state = {
  namespace: localStorage.getItem("ns") || null,
  namespaces: [],
  user: null,
};

let toastTimer = null;
function toast(msg, isError = false) {
  const t = $("#toast");
  t.textContent = msg;
  t.className = isError ? "error" : "";
  t.hidden = false;
  clearTimeout(toastTimer);
  toastTimer = setTimeout(() => { t.hidden = true; }, 4000);
}

function esc(s) {
  // attribute-safe escaping: quotes must be covered because esc() is
  // interpolated into double-quoted HTML attributes (title=, data-*)
  return String(s == null ? "" : s)
    .replace(/&/g, "&amp;")
    .replace(/</g, "&lt;")
    .replace(/>/g, "&gt;")
    .replace(/"/g, "&quot;")
    .replace(/'/g, "&#39;");
}

function age(ts) {
  if (!ts) return "—";
  const s = (Date.now() - new Date(ts).getTime()) / 1000;
  if (s < 90) return `${Math.max(1, Math.round(s))}s`;
  if (s < 5400) return `${Math.round(s / 60)}m`;
  if (s < 129600) return `${Math.round(s / 3600)}h`;
  return `${Math.round(s / 86400)}d`;
}

function statusCell(st) {
  const phase = (st && st.phase) || "waiting";
  const msg = (st && st.message) || "";
  return `<span class="status" title="${esc(msg)}">
    <span class="dot ${esc(phase)}"></span>${esc(phase)}</span>`;
}

// ---- resource-table controls: sort + filter --------------------------
// the reference's shared Angular resource-table ships column sorting
// and a quick text filter; same semantics here, shared by the
// notebooks / volumes / tensorboards list views. Views call
// tableControls(card, columns) once after rendering their skeleton,
// then pipe fetched items through .apply() on every render.

function qty(s) {
  // kubernetes quantity -> number, so Size columns sort by magnitude
  // (lexicographic order would put 10Gi before 5Gi)
  const m = /^([0-9.]+)([KMGTPE]i?|[kmun])?$/.exec(String(s || "").trim());
  if (!m) return 0;
  const mult = { k: 1e3, K: 1e3, M: 1e6, G: 1e9, T: 1e12, P: 1e15,
    E: 1e18, m: 1e-3, u: 1e-6, n: 1e-9,
    Ki: 2 ** 10, Mi: 2 ** 20, Gi: 2 ** 30, Ti: 2 ** 40,
    Pi: 2 ** 50, Ei: 2 ** 60 }[m[2]] || 1;
  return parseFloat(m[1]) * mult;
}

function tableControls(card, columns) {
  // columns: key -> accessor, or key -> {text, sort}. The text
  // accessor MUST return what the cell displays (the filter matches
  // against it); sort may differ (e.g. qty() for Size columns).
  const cols = {};
  for (const [k, v] of Object.entries(columns)) {
    cols[k] = typeof v === "function" ? { text: v, sort: v }
      : { text: v.text, sort: v.sort || v.text };
  }
  const tc = { sortKey: null, dir: 1, q: "", onchange: null };
  const input = document.createElement("input");
  input.type = "search";
  input.placeholder = "filter…";
  input.className = "table-filter";
  card.querySelector("table").before(input);
  input.addEventListener("input", () => {
    tc.q = input.value.toLowerCase();
    if (tc.onchange) tc.onchange();
  });
  const thead = card.querySelector("thead");
  thead.addEventListener("click", (ev) => {
    const th = ev.target.closest("th[data-sort]");
    if (!th) return;
    const key = th.dataset.sort;
    if (tc.sortKey === key) tc.dir = -tc.dir;
    else { tc.sortKey = key; tc.dir = 1; }
    for (const h of thead.querySelectorAll("th[data-sort]")) {
      h.textContent = h.textContent.replace(/ [▲▼]$/, "");
      if (h.dataset.sort === tc.sortKey) {
        h.textContent += tc.dir > 0 ? " ▲" : " ▼";
      }
    }
    if (tc.onchange) tc.onchange();
  });
  tc.apply = (items) => {
    let out = items;
    if (tc.q) {
      out = out.filter((it) => Object.values(cols).some((c) =>
        String(c.text(it) ?? "").toLowerCase().includes(tc.q)));
    }
    if (tc.sortKey) {
      const acc = cols[tc.sortKey].sort;
      out = [...out].sort((a, b) => {
        const va = acc(a) ?? "", vb = acc(b) ?? "";
        return (va > vb ? 1 : va < vb ? -1 : 0) * tc.dir;
      });
    }
    return out;
  };
  return tc;
}

// ---- router ----------------------------------------------------------

const routes = [];
function route(pattern, render) { routes.push({ pattern, render }); }

let activeTimers = [];
function every(ms, fn) { activeTimers.push(setInterval(fn, ms)); }

async function navigate() {
  activeTimers.forEach(clearInterval);
  activeTimers = [];
  const hash = location.hash.replace(/^#/, "") || "/home";
  for (const a of document.querySelectorAll("#nav a")) {
    a.classList.toggle("active", hash.startsWith(a.hash.replace(/^#/, "")));
  }
  for (const { pattern, render } of routes) {
    const m = hash.match(pattern);
    if (m) {
      try {
        await render(...m.slice(1));
      } catch (e) {
        view.innerHTML = `<div class="card">${esc(e.message)}</div>`;
      }
      return;
    }
  }
  location.hash = "#/home";
}

// ---- boot: namespaces ------------------------------------------------

async function loadNamespaces() {
  const data = await get("/jupyter/api/namespaces");
  state.user = data.user;
  state.namespaces = data.namespaces;
  if (!state.namespace || !data.namespaces.includes(state.namespace)) {
    state.namespace = data.namespaces.find((n) => !n.startsWith("kube")) ||
      data.namespaces[0];
  }
  const sel = $("#ns-select");
  sel.innerHTML = state.namespaces
    .map((n) => `<option ${n === state.namespace ? "selected" : ""}>${esc(n)}</option>`)
    .join("");
  sel.onchange = () => {
    state.namespace = sel.value;
    localStorage.setItem("ns", sel.value);
    navigate();
  };
  $("#whoami").textContent = data.user || "";
}

// ---- home ------------------------------------------------------------

// One single-series line panel: 2px line, recessive grid, crosshair +
// tooltip on hover, optional dashed reference line with a direct
// label, and a <details> data table for the no-color/screen-reader
// path. One y-axis per panel — two measures of different scale get
// two panels, never a dual axis.
function lineChart(el, pts, { value, refValue, refLabel, unit }) {
  const W = 520, H = 120, PX = 34, PY = 10;
  const xs = pts.map((p) => p.t);
  const ys = pts.map(value);
  const ref = refValue ? refValue(pts[pts.length - 1]) : null;
  const yMax = Math.max(1, ...ys.filter((v) => v != null),
                        ref ?? 0) * 1.1;
  const x0 = xs[0], x1 = xs[xs.length - 1] || x0 + 1;
  const sx = (t) => PX + (W - PX - 6) *
    (x1 === x0 ? 1 : (t - x0) / (x1 - x0));
  const sy = (v) => H - PY - (H - 2 * PY) * (v / yMax);
  const path = pts
    .map((p, i) => `${i ? "L" : "M"}${sx(p.t).toFixed(1)},` +
                   `${sy(value(p) || 0).toFixed(1)}`)
    .join(" ");
  const gridY = [0.5, 1].map((f) => {
    const v = yMax * f / 1.1;
    return `<line class="grid" x1="${PX}" x2="${W - 6}"
        y1="${sy(v)}" y2="${sy(v)}"></line>
      <text class="tick" x="${PX - 4}" y="${sy(v) + 3}">` +
      `${Math.round(v)}</text>`;
  }).join("");
  const refLine = ref == null ? "" :
    `<line class="ref" x1="${PX}" x2="${W - 6}" y1="${sy(ref)}"
        y2="${sy(ref)}"></line>
     <text class="ref-label" x="${W - 8}" y="${sy(ref) - 3}">` +
     `${esc(refLabel)} ${Math.round(ref)}</text>`;
  // a one-point series has no line extent: draw the point itself so
  // a just-booted dashboard shows data, not a blank panel
  const seed = pts.length === 1
    ? `<circle class="seed" cx="${sx(xs[0])}" cy="${sy(ys[0] || 0)}"
         r="3.5"></circle>` : "";
  el.innerHTML = `
    <svg viewBox="0 0 ${W} ${H}" class="tschart" role="img">
      ${gridY}${refLine}
      <path class="series" d="${path}"></path>${seed}
      <line class="xhair" y1="${PY}" y2="${H - PY}" hidden></line>
      <circle class="dot" r="3.5" hidden></circle>
    </svg>
    <div class="tooltip" hidden></div>
    <details class="chart-data"><summary>data</summary>
      <table><tbody>${pts.slice(-12).map((p) =>
        `<tr><td>${new Date(p.t * 1e3).toLocaleTimeString()}</td>` +
        `<td>${value(p) ?? "–"} ${esc(unit)}</td></tr>`).join("")}
      </tbody></table></details>`;
  const svg = el.querySelector("svg");
  const tip = el.querySelector(".tooltip");
  const xhair = el.querySelector(".xhair");
  const dot = el.querySelector(".dot");
  svg.addEventListener("mousemove", (ev) => {
    const r = svg.getBoundingClientRect();
    const t = x0 + (x1 - x0) *
      ((ev.clientX - r.left) / r.width * W - PX) / (W - PX - 6);
    let best = pts[0];
    for (const p of pts) {
      if (Math.abs(p.t - t) < Math.abs(best.t - t)) best = p;
    }
    const cx = sx(best.t), cy = sy(value(best) || 0);
    xhair.setAttribute("x1", cx); xhair.setAttribute("x2", cx);
    xhair.hidden = false;
    dot.setAttribute("cx", cx); dot.setAttribute("cy", cy);
    dot.hidden = false;
    tip.hidden = false;
    tip.textContent = `${new Date(best.t * 1e3).toLocaleTimeString()}` +
      ` · ${value(best) ?? "–"} ${unit}`;
    tip.style.left = `${Math.min(cx / W * 100, 70)}%`;
  });
  svg.addEventListener("mouseleave", () => {
    tip.hidden = true; xhair.hidden = true; dot.hidden = true;
  });
}

route(/^\/home$/, async () => {
  const ns = state.namespace;
  const [links, metrics, activities] = await Promise.all([
    get("/api/dashboard-links"),
    get("/api/metrics"),
    get(`/api/activities/${ns}`).catch(() => ({ activities: [] })),
  ]);
  const m = metrics.metrics || {};
  view.innerHTML = `
    <div class="card">
      <h2>GPU fleet</h2>
      <p class="sub">Live accelerator inventory</p>
      <div class="row">
        <span class="pill">${esc(m.nodes ?? "–")} GPU nodes</span>
        <span class="pill">${esc(m.chips_capacity ?? "–")} cards capacity</span>
        <span class="pill">${esc(m.chips_requested ?? "–")} cards in use</span>
        <span class="pill">${esc(m.notebooks_running ?? "–")} notebooks running</span>
      </div>
      <div class="charts">
        <div class="chart-panel">
          <h3>GPU cards in use</h3>
          <div id="chart-chips" class="chart"></div>
        </div>
        <div class="chart-panel">
          <h3>Notebooks running</h3>
          <div id="chart-notebooks" class="chart"></div>
        </div>
      </div>
    </div>
    <div class="card quick-links">
      <h2>Quick shortcuts</h2>
      ${(links.links?.quickLinks || [])
        .map((l) => `<a href="#/notebooks/new">${esc(l.desc)}</a>`)
        .join("") || '<a href="#/notebooks/new">Create a new Notebook server</a>'}
    </div>
    <div class="card">
      <h2>Recent activity <span class="pill">${esc(ns)}</span></h2>
      <table><tbody id="act"></tbody></table>
    </div>`;
  try {
    const hist = await get("/api/metrics/history");
    const pts = hist.series || [];
    if (pts.length) {
      lineChart($("#chart-chips"), pts, {
        value: (p) => p.chips_used,
        refValue: (p) => p.chips_capacity, refLabel: "capacity",
        unit: "cards",
      });
      lineChart($("#chart-notebooks"), pts, {
        value: (p) => p.notebooks_running, unit: "notebooks",
      });
    }
  } catch { /* charts are progressive enhancement */ }
  $("#act").innerHTML = (activities.activities || [])
    .slice(0, 12)
    .map((e) => `<tr>
        <td>${esc(e.type)}</td><td>${esc(e.reason)}</td>
        <td>${esc(e.involvedObject?.kind)}/${esc(e.involvedObject?.name)}</td>
        <td>${esc(e.message)}</td>
        <td>${age(e.lastTimestamp)}</td></tr>`)
    .join("") || `<tr><td class="empty">No recent events</td></tr>`;
});

// ---- notebooks table -------------------------------------------------

route(/^\/notebooks$/, async () => {
  const ns = state.namespace;
  view.innerHTML = `
    <div class="card">
      <div class="row" style="justify-content: space-between">
        <div><h2>Notebook servers</h2>
          <p class="sub">GPU slices in <b>${esc(ns)}</b></p></div>
        <button class="primary" id="new-nb">+ New Notebook</button>
      </div>
      <table>
        <thead><tr><th data-sort="status">Status</th>
          <th data-sort="name">Name</th><th data-sort="image">Image</th>
          <th data-sort="tpu">GPU slice</th><th data-sort="age">Age</th>
          <th></th></tr></thead>
        <tbody id="nb-rows"></tbody>
      </table>
    </div>`;
  $("#new-nb").onclick = () => { location.hash = "#/notebooks/new"; };

  const tpuText = (nb) => nb.tpu
    ? `${nb.tpu.acceleratorType} · ${nb.tpu.chips} cards / ${nb.tpu.hosts} hosts`
    : "none";
  const tc = tableControls(view.querySelector(".card"), {
    status: (nb) => nb.status?.phase || "",
    name: (nb) => nb.name,
    image: (nb) => (nb.image || "").split("/").pop(),
    tpu: tpuText,
    age: { text: (nb) => age(nb.age), sort: (nb) => nb.age || "" },
  });
  let items = [];
  tc.onchange = () => render();

  async function refresh() {
    const data = await get(`/jupyter/api/namespaces/${ns}/notebooks`);
    items = data.notebooks;
    render();
  }

  function render() {
    const rows = tc.apply(items).map((nb) => {
      const stopped = nb.status?.phase === "stopped";
      const tpu = tpuText(nb);
      return `<tr class="clickable" data-name="${esc(nb.name)}">
        <td>${statusCell(nb.status)}</td>
        <td><b>${esc(nb.name)}</b></td>
        <td title="${esc(nb.image)}">${esc((nb.image || "").split("/").pop())}</td>
        <td>${esc(tpu)}</td>
        <td>${age(nb.age)}</td>
        <td class="actions">
          <a class="btn" data-act="connect"
             href="/notebook/${esc(ns)}/${esc(nb.name)}/"
             target="_blank" ${nb.status?.phase !== "ready" ? "hidden" : ""}>Connect</a>
          <button data-act="${stopped ? "start" : "stop"}">${stopped ? "Start" : "Stop"}</button>
          <button data-act="delete" class="danger">Delete</button>
        </td></tr>`;
    });
    $("#nb-rows").innerHTML = rows.join("") ||
      `<tr><td colspan="6" class="empty">No notebooks yet — create one.</td></tr>`;
  }

  $("#nb-rows").onclick = async (ev) => {
    const row = ev.target.closest("tr[data-name]");
    if (!row) return;
    const name = row.dataset.name;
    const act = ev.target.dataset.act;
    if (act === "connect") return; // the <a> handles it
    try {
      if (act === "stop") {
        await patch(`/jupyter/api/namespaces/${ns}/notebooks/${name}`, { stopped: true });
        toast(`Stopping ${name}`);
      } else if (act === "start") {
        await patch(`/jupyter/api/namespaces/${ns}/notebooks/${name}`, { stopped: false });
        toast(`Starting ${name}`);
      } else if (act === "delete") {
        if (!confirm(`Delete notebook ${name}?`)) return;
        await del(`/jupyter/api/namespaces/${ns}/notebooks/${name}`);
        toast(`Deleted ${name}`);
      } else {
        location.hash = `#/notebooks/${name}`;
        return;
      }
      await refresh();
    } catch (e) { toast(e.message, true); }
  };

  await refresh();
  every(3000, () => refresh().catch(() => {}));
});

// ---- spawner form ----------------------------------------------------

route(/^\/notebooks\/new$/, async () => {
  const ns = state.namespace;
  const [cfgData, tpuData, pdData, pvcData] = await Promise.all([
    get("/jupyter/api/config"),
    get("/jupyter/api/tpus"),
    get(`/jupyter/api/namespaces/${ns}/poddefaults`).catch(() => ({ poddefaults: [] })),
    get(`/jupyter/api/namespaces/${ns}/pvcs`).catch(() => ({ pvcs: [] })),
  ]);
  const cfg = cfgData.config || {};
  const poddefaults = pdData.poddefaults || [];
  const existingPvcs = (pvcData.pvcs || []).map((p) => p.metadata.name);
  const field = (k) => cfg[k] || {};
  const ro = (k) => (field(k).readOnly ? "disabled" : "");
  // per-server-type image field (backend set_image contract)
  const imageFieldFor = (st) => ({
    "group-one": "imageGroupOne",
    "group-two": "imageGroupTwo",
  }[st] || "image");
  const imageOpts = field("image").options || [];
  const tpus = tpuData.tpus || [];

  view.innerHTML = `
    <div class="card">
      <h2>New notebook server</h2>
      <p class="sub">Namespace <b>${esc(ns)}</b> — cards, hosts and node
        selectors derive from the slice preset server-side.</p>
      <form id="spawn">
        <div class="field">
          <label for="f-name">Name</label>
          <input type="text" id="f-name" required
                 pattern="[a-z0-9]([-a-z0-9]*[a-z0-9])?"
                 placeholder="my-notebook">
        </div>
        <div class="grid2">
          <div class="field">
            <label for="f-image">Image</label>
            <select id="f-image" ${ro("image")}>
              ${imageOpts.map((o) => `<option ${o === field("image").value ? "selected" : ""}>${esc(o)}</option>`).join("")}
            </select>
            ${field("image").readOnly ? '<p class="hint">Pinned by your admin</p>' : ""}
          </div>
          <div class="field">
            <label for="f-servertype">Server type</label>
            <select id="f-servertype" ${ro("serverType")}>
              ${["jupyter", "group-one", "group-two"].map((st) =>
                `<option ${field("serverType").value === st ? "selected" : ""}>${st}</option>`).join("")}
            </select>
            <p class="hint">jupyter · group-one = VSCode · group-two = RStudio</p>
          </div>
          <div class="field">
            <label for="f-cpu">CPU</label>
            <input type="text" id="f-cpu" value="${esc(field("cpu").value || "4")}" ${ro("cpu")}>
          </div>
          <div class="field">
            <label for="f-memory">Memory</label>
            <input type="text" id="f-memory" value="${esc(field("memory").value || "16Gi")}" ${ro("memory")}>
          </div>
        </div>
        <div class="field">
          <label>GPU slice</label>
          <div class="slice-picker" id="f-tpus">
            <span class="slice-chip selected" data-accel="none">none</span>
            ${tpus.map((t) => `<span class="slice-chip" data-accel="${esc(t.acceleratorType)}"
                title="topology ${esc(t.topology)}">${esc(t.acceleratorType)}
                · ${esc(t.chips)} cards / ${esc(t.hosts)} hosts</span>`).join("")}
          </div>
          <p class="hint">Only slice types present in the cluster inventory are offered.</p>
          <div class="row" id="f-multislice" hidden>
            <label for="f-numslices">Slices (network-joined)</label>
            <input type="number" id="f-numslices" value="1" min="1"
                   max="16" style="width: 5em">
          </div>
        </div>
        <div class="field">
          <label><input type="checkbox" id="f-workspace" checked>
            Create a workspace volume (5Gi, mounted at /home/jovyan)</label>
        </div>
        <details class="field">
          <summary>Advanced options</summary>
          ${poddefaults.length ? `
          <div class="field">
            <label>Configurations (PodDefaults)</label>
            ${poddefaults.map((pd) => {
              const key = Object.keys(pd.label || {})[0];
              return key ? `<label class="inline">
                <input type="checkbox" class="f-poddefault"
                       value="${esc(key)}"> ${esc(pd.desc)}</label>` : "";
            }).join("")}
          </div>` : ""}
          <div class="field">
            <label for="f-datavols">Data volumes</label>
            <div id="f-datavols"></div>
            <button type="button" class="btn" id="f-addvol">+ Attach volume</button>
            <p class="hint">Mount an existing PVC or create a new one per row.</p>
          </div>
          <div class="grid2">
            <div class="field">
              <label for="f-tolerations">Tolerations</label>
              <select id="f-tolerations" ${ro("tolerationGroup")}>
                ${(field("tolerationGroup").options || [{ groupKey: "none", displayName: "No toleration" }])
                  .map((g) => `<option value="${esc(g.groupKey)}"
                    ${g.groupKey === field("tolerationGroup").value ? "selected" : ""}>
                    ${esc(g.displayName || g.groupKey)}</option>`).join("")}
              </select>
            </div>
            <div class="field">
              <label for="f-affinity">Affinity</label>
              <select id="f-affinity" ${ro("affinityConfig")}>
                <option value="none">none</option>
                ${(field("affinityConfig").options || [])
                  .map((a) => `<option value="${esc(a.configKey)}"
                    ${a.configKey === field("affinityConfig").value ? "selected" : ""}>
                    ${esc(a.displayName || a.configKey)}</option>`).join("")}
              </select>
            </div>
          </div>
          <div class="field">
            <label for="f-env">Environment variables (KEY=VALUE, one per line)</label>
            <textarea id="f-env" rows="3" placeholder="HF_HOME=/home/jovyan/.cache"></textarea>
          </div>
          <div class="field">
            <label><input type="checkbox" id="f-shm"
              ${field("shm").value === false ? "" : "checked"} ${ro("shm")}>
              Mount /dev/shm (Memory-backed)</label>
          </div>
        </details>
        <div class="row">
          <button type="submit" class="primary">Launch</button>
          <a class="btn" href="#/notebooks">Cancel</a>
        </div>
      </form>
    </div>`;

  // data-volume rows: existing-PVC picker or new-PVC spec
  const volRows = [];
  $("#f-addvol").onclick = () => {
    const idx = volRows.length;
    const row = document.createElement("div");
    row.className = "row volrow";
    row.innerHTML = `
      <select class="v-src">
        <option value="">new volume…</option>
        ${existingPvcs.map((p) => `<option>${esc(p)}</option>`).join("")}
      </select>
      <input class="v-name" placeholder="name" value="{notebook-name}-vol-${idx}">
      <input class="v-size" placeholder="size" value="5Gi" size="5">
      <input class="v-mount" placeholder="mount" value="/home/jovyan/data-${idx}">
      <button type="button" class="btn v-del">✕</button>`;
    const sync = () => {
      const isNew = !row.querySelector(".v-src").value;
      row.querySelector(".v-name").hidden = !isNew;
      row.querySelector(".v-size").hidden = !isNew;
    };
    row.querySelector(".v-src").onchange = sync;
    row.querySelector(".v-del").onclick = () => {
      volRows.splice(volRows.indexOf(row), 1);
      row.remove();
    };
    $("#f-datavols").appendChild(row);
    volRows.push(row);
    sync();
  };

  // server type drives which image list the dropdown offers
  $("#f-servertype").onchange = () => {
    const f = field(imageFieldFor($("#f-servertype").value));
    $("#f-image").innerHTML = (f.options || [])
      .map((o) => `<option ${o === f.value ? "selected" : ""}>${esc(o)}</option>`)
      .join("");
  };

  let accel = "none";
  $("#f-tpus").onclick = (ev) => {
    const chip = ev.target.closest(".slice-chip");
    if (!chip) return;
    accel = chip.dataset.accel;
    for (const c of document.querySelectorAll(".slice-chip")) {
      c.classList.toggle("selected", c === chip);
    }
    $("#f-multislice").hidden = accel === "none";
  };

  $("#spawn").onsubmit = async (ev) => {
    ev.preventDefault();
    const name = $("#f-name").value.trim();
    const serverType = $("#f-servertype").value;
    const environment = {};
    for (const line of $("#f-env").value.split("\n")) {
      const m = line.match(/^\s*([^=\s]+)\s*=\s*(.*)$/);
      if (m) environment[m[1]] = m[2];
    }
    const datavols = volRows.map((row) => {
      const src = row.querySelector(".v-src").value;
      const mount = row.querySelector(".v-mount").value;
      if (src) {
        return { mount, existingSource: {
          persistentVolumeClaim: { claimName: src } } };
      }
      return { mount, newPvc: {
        metadata: { name: row.querySelector(".v-name").value },
        spec: {
          resources: { requests: {
            storage: row.querySelector(".v-size").value } },
          accessModes: ["ReadWriteOnce"],
        } } };
    });
    const body = {
      name,
      [imageFieldFor(serverType)]: $("#f-image").value,
      imagePullPolicy: "IfNotPresent",
      serverType,
      cpu: $("#f-cpu").value,
      memory: $("#f-memory").value,
      tpu: accel === "none" ? null : {
        acceleratorType: accel,
        numSlices: parseInt($("#f-numslices").value, 10) || 1,
      },
      tolerationGroup: $("#f-tolerations").value,
      affinityConfig: $("#f-affinity").value,
      configurations: [...document.querySelectorAll(".f-poddefault:checked")]
        .map((el) => el.value),
      shm: $("#f-shm").checked,
      environment,
      datavols,
    };
    if ($("#f-workspace").checked) {
      body.workspace = {
        mount: "/home/jovyan",
        newPvc: {
          metadata: { name: "{notebook-name}-workspace" },
          spec: {
            resources: { requests: { storage: "5Gi" } },
            accessModes: ["ReadWriteOnce"],
          },
        },
      };
    }
    try {
      await post(`/jupyter/api/namespaces/${ns}/notebooks`, body);
      toast(`Notebook ${name} created`);
      location.hash = "#/notebooks";
    } catch (e) { toast(e.message, true); }
  };
});

// ---- notebook detail: status ladder, events, per-ordinal logs --------

route(/^\/notebooks\/([a-z0-9][-a-z0-9]*)$/, async (name) => {
  const ns = state.namespace;

  view.innerHTML = `
    <div class="card">
      <div class="row" style="justify-content: space-between">
        <h2>${esc(name)} <span id="d-status"></span></h2>
        <a class="btn" href="#/notebooks">← Back</a>
      </div>
      <dl class="kv" id="d-kv"></dl>
    </div>
    <div class="card">
      <h2>Slice pods</h2>
      <p class="sub">One pod per GPU host; click to inspect its logs.</p>
      <div class="tabs" id="d-pods"></div>
      <div class="logbox" id="d-logs">select a pod</div>
    </div>
    <div class="card">
      <h2>Events</h2>
      <table><thead><tr><th>Type</th><th>Reason</th><th>Message</th>
        <th>Age</th></tr></thead><tbody id="d-events"></tbody></table>
    </div>`;

  let currentPod = null;

  async function refreshDetail() {
    const data = await get(`/jupyter/api/namespaces/${ns}/notebooks/${name}`);
    const nb = data.notebook;
    $("#d-status").innerHTML = statusCell(nb.processed_status);
    const tpu = nb.spec?.tpu || {};
    $("#d-kv").innerHTML = `
      <dt>Image</dt><dd>${esc(nb.spec?.template?.spec?.containers?.[0]?.image)}</dd>
      <dt>GPU slice</dt><dd>${esc(tpu.acceleratorType || "none")}</dd>
      <dt>Ready / desired hosts</dt>
      <dd>${esc(nb.status?.readyReplicas ?? 0)} / ${esc(nb.status?.desiredReplicas ?? 0)}</dd>
      <dt>Conditions</dt>
      <dd>${(nb.status?.conditions || []).map((c) => `${esc(c.type)}=${esc(c.status)}`).join(", ") || "—"}</dd>
      <dt>Connect</dt>
      <dd><a href="/notebook/${esc(ns)}/${esc(name)}/" target="_blank">/notebook/${esc(ns)}/${esc(name)}/</a></dd>`;
  }

  async function refreshPods() {
    const data = await get(`/jupyter/api/namespaces/${ns}/notebooks/${name}/pods`);
    $("#d-pods").innerHTML = data.pods
      .map((p, i) => `<button data-pod="${i}" class="${p.name === currentPod ? "active" : ""}">
         ${esc(p.name)} · ${esc(p.phase || "Pending")}</button>`)
      .join("") || '<span class="empty">no pods yet</span>';
    if (!currentPod && data.pods.length) {
      currentPod = data.pods[0].name;
      await refreshLogs();
    }
  }

  async function refreshLogs() {
    if (!currentPod) return;
    const ordinal = currentPod.split("-").pop();
    const data = await get(
      `/jupyter/api/namespaces/${ns}/notebooks/${name}/pods/${ordinal}/logs`);
    $("#d-logs").textContent = data.logs.join("\n") || "(no output yet)";
  }

  async function refreshEvents() {
    const data = await get(`/jupyter/api/namespaces/${ns}/notebooks/${name}/events`);
    $("#d-events").innerHTML = data.events
      .map((e) => `<tr><td>${esc(e.type)}</td><td>${esc(e.reason)}</td>
           <td>${esc(e.message)}</td><td>${age(e.lastTimestamp)}</td></tr>`)
      .join("") || `<tr><td colspan="4" class="empty">No events</td></tr>`;
  }

  $("#d-pods").onclick = async (ev) => {
    const b = ev.target.closest("button[data-pod]");
    if (!b) return;
    currentPod = b.textContent.trim().split(" ")[0].replace(/·.*/, "").trim();
    for (const x of document.querySelectorAll("#d-pods button")) {
      x.classList.toggle("active", x === b);
    }
    await refreshLogs();
  };

  await Promise.all([refreshDetail(), refreshPods(), refreshEvents()]);
  every(3000, () => Promise.all(
    [refreshDetail(), refreshPods(), refreshLogs(), refreshEvents()],
  ).catch(() => {}));
});

// ---- volumes ---------------------------------------------------------

route(/^\/volumes$/, async () => {
  const ns = state.namespace;
  view.innerHTML = `
    <div class="card">
      <h2>Volumes</h2>
      <p class="sub">PersistentVolumeClaims in <b>${esc(ns)}</b></p>
      <table>
        <thead><tr><th data-sort="name">Name</th>
          <th data-sort="size">Size</th><th data-sort="access">Access</th>
          <th data-sort="usedby">Used by</th><th>Viewer</th><th></th>
        </tr></thead>
        <tbody id="pvc-rows"></tbody>
      </table>
    </div>`;

  const tc = tableControls(view.querySelector(".card"), {
    name: (r) => r.pvc.metadata.name,
    size: { text: (r) => r.pvc.spec?.resources?.requests?.storage || "",
            sort: (r) => qty(r.pvc.spec?.resources?.requests?.storage) },
    access: (r) => (r.pvc.spec?.accessModes || []).join(","),
    usedby: (r) => r.inUseBy.join(", ") || "—",
  });
  let items = [];
  tc.onchange = () => render();

  async function refresh() {
    const data = await get(`/volumes/api/namespaces/${ns}/pvcs`);
    items = data.pvcs;
    render();
  }

  function render() {
    $("#pvc-rows").innerHTML = tc.apply(items)
      .map((row) => {
        const pvc = row.pvc;
        const name = pvc.metadata.name;
        return `<tr data-name="${esc(name)}">
          <td><b>${esc(name)}</b></td>
          <td>${esc(pvc.spec?.resources?.requests?.storage)}</td>
          <td>${esc((pvc.spec?.accessModes || []).join(","))}</td>
          <td>${esc(row.inUseBy.join(", ") || "—")}</td>
          <td>${row.viewer ? esc(row.viewer) : "—"}</td>
          <td class="actions">
            <button data-act="browse">${row.viewer ? "Close browser" : "Browse"}</button>
            <button data-act="delete" class="danger"
              ${row.inUseBy.length ? "disabled title='in use'" : ""}>Delete</button>
          </td></tr>`;
      })
      .join("") || `<tr><td colspan="6" class="empty">No volumes</td></tr>`;
  }

  $("#pvc-rows").onclick = async (ev) => {
    const row = ev.target.closest("tr[data-name]");
    const act = ev.target.dataset.act;
    if (!row || !act) return;
    const name = row.dataset.name;
    try {
      if (act === "browse") {
        const hasViewer = ev.target.textContent.includes("Close");
        if (hasViewer) {
          await del(`/volumes/api/namespaces/${ns}/viewers/${name}`);
          toast("Viewer deleted");
        } else {
          await post(`/volumes/api/namespaces/${ns}/viewers/${name}`);
          toast("Viewer starting — it appears in the table when ready");
        }
      } else if (act === "delete") {
        if (!confirm(`Delete PVC ${name}?`)) return;
        await del(`/volumes/api/namespaces/${ns}/pvcs/${name}`);
        toast(`Deleted ${name}`);
      }
      await refresh();
    } catch (e) { toast(e.message, true); }
  };

  await refresh();
  every(4000, () => refresh().catch(() => {}));
});

// ---- tensorboards ----------------------------------------------------

route(/^\/tensorboards$/, async () => {
  const ns = state.namespace;
  view.innerHTML = `
    <div class="card">
      <h2>Tensorboards</h2>
      <p class="sub">Serving from PVC or GCS log dirs in <b>${esc(ns)}</b></p>
      <table>
        <thead><tr><th data-sort="status">Status</th>
          <th data-sort="name">Name</th><th data-sort="logspath">Logspath</th>
          <th data-sort="age">Age</th><th></th></tr></thead>
        <tbody id="tb-rows"></tbody>
      </table>
    </div>
    <div class="card">
      <h2>New tensorboard</h2>
      <form id="tb-form" class="row">
        <input type="text" id="tb-name" placeholder="name" required
               pattern="[a-z0-9]([-a-z0-9]*[a-z0-9])?">
        <input type="text" id="tb-logspath" required
               placeholder="pvc://my-pvc/logs or gs://bucket/dir">
        <button type="submit" class="primary">Create</button>
      </form>
    </div>`;

  const tc = tableControls(view.querySelector(".card"), {
    status: (tb) => tb.status?.phase || "",
    name: (tb) => tb.name,
    logspath: (tb) => tb.logspath || "",
    age: { text: (tb) => age(tb.age), sort: (tb) => tb.age || "" },
  });
  let items = [];
  tc.onchange = () => render();

  async function refresh() {
    const data = await get(`/tensorboards/api/namespaces/${ns}/tensorboards`);
    items = data.tensorboards;
    render();
  }

  function render() {
    $("#tb-rows").innerHTML = tc.apply(items)
      .map((tb) => `<tr data-name="${esc(tb.name)}">
          <td>${statusCell(tb.status)}</td>
          <td><b>${esc(tb.name)}</b></td>
          <td>${esc(tb.logspath)}</td>
          <td>${age(tb.age)}</td>
          <td class="actions">
            <button data-act="delete" class="danger">Delete</button>
          </td></tr>`)
      .join("") || `<tr><td colspan="5" class="empty">No tensorboards</td></tr>`;
  }

  $("#tb-rows").onclick = async (ev) => {
    const row = ev.target.closest("tr[data-name]");
    if (!row || ev.target.dataset.act !== "delete") return;
    try {
      await del(`/tensorboards/api/namespaces/${ns}/tensorboards/${row.dataset.name}`);
      toast("Deleted");
      await refresh();
    } catch (e) { toast(e.message, true); }
  };

  $("#tb-form").onsubmit = async (ev) => {
    ev.preventDefault();
    try {
      await post(`/tensorboards/api/namespaces/${ns}/tensorboards`, {
        name: $("#tb-name").value.trim(),
        logspath: $("#tb-logspath").value.trim(),
      });
      toast("Tensorboard created");
      await refresh();
    } catch (e) { toast(e.message, true); }
  };

  await refresh();
  every(4000, () => refresh().catch(() => {}));
});

// ---- members (KFAM) --------------------------------------------------

route(/^\/members$/, async () => {
  const ns = state.namespace;
  view.innerHTML = `
    <div class="card">
      <h2>Contributors <span class="pill">${esc(ns)}</span></h2>
      <table>
        <thead><tr><th>User</th><th>Role</th><th></th></tr></thead>
        <tbody id="mb-rows"></tbody>
      </table>
    </div>
    <div class="card">
      <h2>Add contributor</h2>
      <form id="mb-form" class="row">
        <input type="text" id="mb-user" placeholder="user@example.com" required>
        <select id="mb-role"><option>edit</option><option>view</option></select>
        <button type="submit" class="primary">Add</button>
      </form>
    </div>`;

  async function refresh() {
    const data = await get(`/kfam/kfam/v1/bindings?namespace=${ns}`);
    $("#mb-rows").innerHTML = (data.bindings || [])
      .map((b) => `<tr data-user="${esc(b.user?.name)}" data-role="${esc(b.roleRef?.name)}">
          <td>${esc(b.user?.name)}</td>
          <td>${esc(b.roleRef?.name)}</td>
          <td class="actions"><button data-act="remove" class="danger">Remove</button></td>
        </tr>`)
      .join("") || `<tr><td colspan="3" class="empty">No contributors</td></tr>`;
  }

  $("#mb-rows").onclick = async (ev) => {
    const row = ev.target.closest("tr[data-user]");
    if (!row || ev.target.dataset.act !== "remove") return;
    try {
      await api("DELETE", "/kfam/kfam/v1/bindings", {
        user: { kind: "User", name: row.dataset.user },
        referredNamespace: ns,
        roleRef: { kind: "ClusterRole", name: row.dataset.role },
      });
      toast("Contributor removed");
      await refresh();
    } catch (e) { toast(e.message, true); }
  };

  $("#mb-form").onsubmit = async (ev) => {
    ev.preventDefault();
    try {
      await post("/kfam/kfam/v1/bindings", {
        user: { kind: "User", name: $("#mb-user").value.trim() },
        referredNamespace: ns,
        roleRef: { kind: "ClusterRole",
                   name: $("#mb-role").value === "view" ? "view" : "edit" },
      });
      toast("Contributor added");
      await refresh();
    } catch (e) { toast(e.message, true); }
  };

  await refresh();
});

// ---- boot ------------------------------------------------------------

window.addEventListener("hashchange", navigate);
loadNamespaces()
  .then(navigate)
  .catch((e) => { view.innerHTML = `<div class="card">${esc(e.message)}</div>`; });
